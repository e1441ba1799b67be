"""The inference slice as a whole: one frame of the port's ``make_infer_fn``
against the JAX ``make_infer_fn`` on the same scene, weights, bank and
template, and the port's infer CLI on a checkpoint of its train CLI.

Set-up as in ``test_torch_step.py`` (``test_torch_common.py``): narrow
nets with JAX weights, the toy skinner, the synthetic scene and the JAX
remesh of the init SDF.  Two sizes differ, so that the JAX Pallas
rasterizer's 128-entry cells drop nothing (the test asserts it) and every
triangle fits its 2x2 block of 8 px cells: a 9^3 sweep over
[-1, 1]^3 (156 vertices) and a 40x40 scene (at 32x32 the body covers
~5 cells and JAX drops faces from them).  The scene's camera sits at the
origin with the body's distance in trans, as in the reference data, so that
the def1 camera (at the mean trans) sees the body from outside.  JAX
runs its Pallas kernel in interpret mode; the port runs the kernel's plain
version.

Tolerances: maskE 1e-6; hit masks identical; deformed vertices 1e-5;
Phong and def1 images 1e-4 on pixels whose face ids agree (float32 sums in
another order; a shared-edge pixel may go to either face at equal depth);
colours: the converged sets agree on >= 99% of hit pixels (a ray's
convergence test is a threshold, which summation order can flip) and the
colours on the common set within 1e-3.
"""
import os.path as osp
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.cli import infer as JCLI
from selfreconcode_tpu.engine import inference as JINF
from selfreconcode_tpu.models import deformer as JD
from selfreconcode_tpu.models import translator as JT
from selfreconcode_tpu.ops import rasterize as JRA
from selfreconcode_tpu.render import camera as JCAM
from selfreconcode_tpu.utils.math import quat2mat
from selfreconcode_tpu_torch.engine.inference import make_infer_fn
from selfreconcode_tpu_torch.interop import bank_from_jax
from selfreconcode_tpu_torch.ops.rasterize import rasterize_mesh
from selfreconcode_tpu_torch.render import camera as TCAM
from test_torch_common import (jax_scene, port_nets, port_skinner,
                               port_template)

H = W = 40
RES = ((5, 5, 5), (9, 9, 9))
FID = 1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _views(bank_np, fid):
    """(camera, fixed def1 camera) as JAX and as port cameras."""
    c = bank_np["camera"]
    R = np.asarray(quat2mat(jnp.asarray(c["cam2world_coord_quat"]).reshape(
        1, 4))[0])
    R1 = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
    T1 = bank_np["trans"].mean(0)
    out = []
    for rot, T in ((R, c["world2cam_coord_trans"]), (R1, T1)):
        args = (c["focal_length"], c["princeple_points"])
        out.append((JCAM.Camera(*(jnp.asarray(a) for a in args),
                                jnp.asarray(rot), jnp.asarray(T), H, W),
                    TCAM.Camera(*(torch.tensor(np.asarray(a, np.float32))
                                  for a in (*args, rot, T)), H, W)))
    return out


def _faces_agree(view, jverts, tverts, s):
    """Pixels where both rasterizers pick the same face (JAX drops none)."""
    jcam, tcam = view
    jf = JRA.rasterize_mesh(jcam, jnp.asarray(jverts), s["tmp"].faces,
                            s["tmp"].face_valid, 8)
    assert int(jf.overflow) == 0, "JAX dropped faces: not comparable"
    tf = rasterize_mesh(tcam, torch.tensor(tverts),
                        torch.tensor(np.asarray(s["tmp"].faces)[:s["nf"]]))
    return np.asarray(jf.pix_to_face) == tf.pix_to_face.numpy()


@pytest.fixture(scope="module")
def infer_results(tmp_path_factory):
    s = jax_scene(str(tmp_path_factory.mktemp("infer")), res=RES,
                  depth_in_trans=True, half=1.0, hw=H)
    ds, nv = s["ds"], s["nv"]
    gt = ds.frame_data(FID)["mask"].astype(np.float32)
    bank_np = jax.tree_util.tree_map(np.asarray, ds.param_bank())
    jdef = JD.Deformer(translator=s["nets"][1], skinner=s["jsk"])
    jtrainer = SimpleNamespace(
        sdf_net=s["nets"][0], trans_net=s["nets"][1],
        render_net=s["nets"][2], deformer=jdef,
        dataset=SimpleNamespace(H=H, W=W), ang_thresh=s["ang"])
    jinfer = JINF.make_infer_fn(jtrainer, footprint=8, chunk=256)
    jout = jax.device_get(jinfer(
        s["params"], jax.tree_util.tree_map(jnp.asarray, bank_np), s["tmp"],
        jnp.asarray(FID, jnp.int32), jnp.asarray(gt)))
    jtverts, _ = JT.translator_apply(
        s["params"]["trans"], s["nets"][1], s["tmp"].verts,
        jnp.broadcast_to(jnp.asarray(bank_np["cond_deformer"][FID]),
                         (s["vcap"], 8)), 1.0)

    params_np = jax.tree_util.tree_map(np.asarray, s["params"])
    trainer = SimpleNamespace(nets=port_nets(params_np),
                              skinner=port_skinner(s["jsk"]),
                              dataset=SimpleNamespace(H=H, W=W),
                              ang_thresh=s["ang"])
    tbank = {k: torch.tensor(v) for k, v in bank_from_jax(bank_np).items()}
    tmp = port_template(s)
    out = make_infer_fn(trainer, footprint=8, chunk=256)(
        tbank, tmp, FID, torch.tensor(gt))
    with torch.no_grad():
        tverts, _ = trainer.nets.translator(tmp.verts, tbank["dcond"][FID],
                                            1.0)
    views = _views(bank_np, FID)
    agree = (_faces_agree(views[0], np.asarray(jout["def_verts"])[:nv],
                          out["def_verts"].numpy(), s),
             _faces_agree(views[1], np.asarray(jtverts)[:nv],
                          tverts.numpy(), s))
    return dict(j=jout, t=out, nv=nv, agree=agree)


def test_mask_error_and_hit_match(infer_results):
    j, t = infer_results["j"], infer_results["t"]
    np.testing.assert_array_equal(t["hit"].numpy(), np.asarray(j["hit"]))
    assert t["hit"].sum() > 50
    np.testing.assert_allclose(float(t["mask_err"]), float(j["mask_err"]),
                               rtol=0, atol=1e-6)
    assert 0.0 <= float(t["mask_err"]) <= 1.0


def test_deformed_vertices_match(infer_results):
    j, t, nv = infer_results["j"], infer_results["t"], infer_results["nv"]
    np.testing.assert_allclose(t["def_verts"].numpy(),
                               np.asarray(j["def_verts"])[:nv], atol=1e-5)


@pytest.mark.parametrize("key,view", [("mesh_img", 0), ("def1_img", 1)])
def test_phong_renders_match(infer_results, key, view):
    j, t = infer_results["j"], infer_results["t"]
    agree = infer_results["agree"][view]
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(t[key].numpy()[agree],
                               np.asarray(j[key])[agree], atol=1e-4)
    assert (t[key].numpy() < 1.0).any()


def test_colours_match(infer_results):
    j, t = infer_results["j"], infer_results["t"]
    hit = t["hit"].numpy()
    jc, tc = np.asarray(j["color_img"]), t["color_img"].numpy()
    # a converged pixel carries the colour net's output, the rest stay white
    jconv = hit & ~(jc == 1.0).all(-1)
    tconv = hit & ~(tc == 1.0).all(-1)
    assert tconv.sum() >= 0.5 * hit.sum()
    assert (jconv == tconv)[hit].mean() >= 0.99
    both = jconv & tconv
    np.testing.assert_allclose(tc[both], jc[both], atol=1e-3)
    assert (tc[~hit] == 1.0).all()
    st = t["stats"]
    assert st["hit_pixels"] == hit.sum()
    assert st["converged_pixels"] == tconv.sum()


def test_infer_cli_on_cpu(tmp_path):
    """Port-only: cli.train.main writes a checkpoint, cli.infer.main infers
    two frames from it; errors.txt in the JAX CLI's format."""
    from selfreconcode_tpu_torch.cli import infer as icli
    from selfreconcode_tpu_torch.cli import train as tcli
    from selfreconcode_tpu_torch.data.dataset import \
        make_synthetic_scene as port_scene

    scene = tmp_path / "scene"
    port_scene(str(scene), n_frames=4, H=H, W=W)
    conf = open(osp.join(osp.dirname(__file__), "..", "configs",
                         "config.conf")).read()
    conf = conf.replace("initial_iters = -1200", "initial_iters = -30")
    (tmp_path / "c.conf").write_text(conf)
    res = {st: [(9, 9, 9), (17, 17, 17)] for st in ("coarse", "medium",
                                                      "fine")}

    def tune(tr):
        tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                          surf_iters=2)

    tcli.main(["--conf", str(tmp_path / "c.conf"), "--data", str(scene),
               "--save-folder", "rec", "--toy-smpl", "--max-epochs", "0",
               "--device", "cpu"], resolutions=res, skinner_res=(17, 29, 9),
              tune=tune)
    rec = scene / "rec"
    summary = icli.main(["--rec-root", str(rec), "--toy-smpl", "--frames",
                         "2", "--device", "cpu"], resolutions=res)
    assert [fr["fid"] for fr in summary["frames"]] == [0, 1]
    assert sorted(p.name for p in (rec / "meshs").glob("*.npy")) == \
        ["0.npy", "1.npy"]
    nv = summary["template_verts"]
    assert np.load(rec / "meshs" / "0.npy").shape == (nv, 3)
    for sub in ("meshs", "def1meshs", "colors"):
        assert (rec / sub / "0.png").is_file()
    assert (rec / "tmp.ply").read_text().startswith("ply\n")
    errs = summary["mask_errors"]
    assert (errs[:2] >= 0).all() and (errs[:2] <= 1).all()
    assert (errs[2:] == -1).all()
    text = (rec / "errors.txt").read_text()
    JCLI._write_errors(str(tmp_path), errs)
    assert text == (tmp_path / "errors.txt").read_text()
    assert text.splitlines()[0].startswith("maskE, mean: ")
    assert text.splitlines()[2:4] == ["0: %f" % errs[0], "1: %f" % errs[1]]
    with pytest.raises(SystemExit):
        icli.parse_args(["--rec-root", str(rec), "--gpu-ids", "0"])


def test_infer_cli_synthetic_body_on_cpu(tmp_path):
    """Port-only: both CLIs with --synthetic-body on a 40x40 subject of the
    6890-vertex body; maskE now scores the template against the body's own
    silhouettes.  The IGR cache is the SDF's geometric init with bias 0.5 (a
    sphere of radius ~0.27 inside the sweep box), so training skips IGR."""
    import torch

    from selfreconcode_tpu_torch.cli import infer as icli
    from selfreconcode_tpu_torch.cli import train as tcli
    from selfreconcode_tpu_torch.data.synthetic_subject import \
        make_synthetic_subject
    from selfreconcode_tpu_torch.models.sdf import SDFNet

    scene = tmp_path / "subject"
    make_synthetic_subject(str(scene), n_frames=4, H=H, W=W, verbose=False,
                           device="cpu")
    torch.save(SDFNet(multires=6, bias=0.5, seed=1).state_dict(),
               scene / "initial_sdf_idr_6_1_torch.pt")
    conf = open(osp.join(osp.dirname(__file__), "..", "configs",
                         "config.conf")).read()
    (tmp_path / "c.conf").write_text(conf)
    res = {st: [(9, 9, 9), (17, 17, 17)] for st in ("coarse", "medium",
                                                      "fine")}

    def tune(tr):
        tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                          surf_iters=2)

    tcli.main(["--conf", str(tmp_path / "c.conf"), "--data", str(scene),
               "--save-folder", "rec", "--synthetic-body", "--max-epochs",
               "0", "--device", "cpu"], resolutions=res,
              skinner_res=(17, 29, 9), tune=tune)
    summary = icli.main(["--rec-root", str(scene / "rec"), "--synthetic-body",
                         "--frames", "1", "--nV", "--device", "cpu"],
                        resolutions=res)
    assert summary["trainer"].body_vs.shape == (6890, 3)
    (fr,) = summary["frames"]
    assert fr["hit_pixels"] > 0
    assert 0.0 <= summary["mask_errors"][0] < 1.0
    assert (scene / "rec" / "meshs" / "0.png").is_file()
