"""The port's A/B tools (``selfreconcode_tpu_torch/tools``) against the JAX
package's ``tools/ab_convergence.py`` and ``tools/ab_stage_resume.py``.

* ``eval_mask_iou`` against JAX's on one carried-over state: the scene,
  narrow nets, toy skinner and 9^3-sweep template of
  ``test_torch_infer.py`` (a 40x40 scene, where JAX's Pallas rasterizer, in
  interpret mode, drops no face: the test holds its overflow to 0; the port
  runs the kernel's plain version), on 2 frames.  Tolerance: |dIoU| <= 1e-3
  (a shared-edge pixel may go to either face; a hit differs only where the
  two rasterizers' edge tests round a pixel centre on an edge otherwise).
* The variant names, and the stage fields each sets, against JAX's (less
  JAX's splat capacities, which the port does not have).
* Both tools end to end on the CPU at a 32x32 subject of the synthetic
  body with small sample counts: ``ab_stage_resume`` from a tiny train-CLI
  run's ``coarse.pt`` into the medium stage, ``ab_convergence`` rendering
  its subject and reading an IGR cache, and their refusal to run without
  CUDA by default.
"""
import ast
import dataclasses
import importlib.util
import math
import os.path as osp
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.models import deformer as JD
from selfreconcode_tpu.ops import rasterize as JRA
from selfreconcode_tpu_torch.data.dataset import SceneDataset
from selfreconcode_tpu_torch.interop import bank_from_jax
from selfreconcode_tpu_torch.tools import ab_convergence as AB
from selfreconcode_tpu_torch.tools import ab_stage_resume as ABR
from test_torch_common import (jax_scene, port_nets, port_skinner,
                               port_template)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_TOOLS = osp.join(REPO, "tools")
RES = [(9, 9, 9), (17, 17, 17)]
SPLAT_CAPS = {"splat_cap", "splat_cap_max"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_variants(name):
    """The dict literal bound to `variants` / `VARIANTS` in a JAX tool, read
    from its source (the JAX tools run nothing at import, but
    ab_stage_resume imports its sibling by a bare name)."""
    tree = ast.parse(open(osp.join(JAX_TOOLS, name)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.lower() == "variants"):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no variants dict in {name}")


@pytest.mark.parametrize("tool,port", [("ab_convergence.py", AB.VARIANTS),
                                       ("ab_stage_resume.py", ABR.VARIANTS)])
def test_variants_match_jax(tool, port):
    ref = jax_variants(tool)
    assert set(port) == set(ref)
    for name, fields in ref.items():
        assert port[name] == {k: v for k, v in fields.items()
                              if k not in SPLAT_CAPS}, name


def test_eval_mask_iou_matches_jax(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_ab_convergence", osp.join(JAX_TOOLS, "ab_convergence.py"))
    jab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jab)
    hw, footprint = 40, 8
    s = jax_scene(str(tmp_path), res=((5, 5, 5), (9, 9, 9)),
                  depth_in_trans=True, half=1.0, hw=hw)
    ds = s["ds"]
    bank_np = jax.tree_util.tree_map(np.asarray, ds.param_bank())
    overflow = []
    raster = JRA.rasterize_mesh

    def counted_raster(*a, **kw):
        frags = raster(*a, **kw)
        overflow.append(int(frags.overflow))
        return frags

    monkeypatch.setattr(JRA, "rasterize_mesh", counted_raster)
    stage = SimpleNamespace(raster_footprint=footprint)
    jtr = SimpleNamespace(
        state=SimpleNamespace(tmp=s["tmp"], params=s["params"],
                              bank=jax.tree_util.tree_map(jnp.asarray,
                                                          bank_np)),
        deformer=JD.Deformer(translator=s["nets"][1], skinner=s["jsk"]),
        _host_camera=lambda: jax_host_camera(ds, hw), stage_cfg=stage)
    fids = np.array([0, 3])
    j_iou = jab.eval_mask_iou(jtr, ds, fids)
    assert overflow == [0, 0], "JAX dropped faces: not comparable"

    nets = port_nets(jax.tree_util.tree_map(np.asarray, s["params"]))
    ttr = SimpleNamespace(
        tmp=port_template(s), nets=nets, skinner=port_skinner(s["jsk"]),
        bank={k: torch.tensor(v) for k, v in bank_from_jax(bank_np).items()},
        stage_cfg=stage)
    tds = SceneDataset(osp.join(str(tmp_path), "scene"))
    t_iou = AB.eval_mask_iou(ttr, tds, fids)
    assert 0.0 < j_iou < 1.0          # neither empty nor trivially whole
    assert abs(t_iou - j_iou) <= 1e-3, (t_iou, j_iou)


def jax_host_camera(ds, hw):
    """The JAX trainer's _host_camera of this dataset."""
    from selfreconcode_tpu.render.camera import Camera
    from selfreconcode_tpu.utils.math import quat2mat
    cp = ds.camera_params
    R = np.asarray(quat2mat(jnp.asarray(cp["cam2world_coord_quat"]).reshape(
        1, 4))[0])
    return Camera(focal=jnp.asarray(cp["focal_length"]),
                  principal=jnp.asarray(cp["princeple_points"]),
                  R=jnp.asarray(R), T=jnp.asarray(cp["world2cam_coord_trans"]),
                  H=hw, W=hw)


def small_counts(trainer):
    """Sample counts a CPU run can afford, in any stage."""
    trainer.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                           surf_iters=2, weights=dataclasses.replace(
                               trainer.stage_cfg.weights, sample_pix_num=0))


def subject_with_igr_cache(root):
    """A 32x32 4-frame subject of the synthetic body, and an IGR cache in
    its root (the SDF's geometric init with bias 0.5: a sphere of radius
    ~0.27 inside the body's sweep box), so no run pretrains."""
    from selfreconcode_tpu_torch.data.synthetic_subject import \
        make_synthetic_subject
    from selfreconcode_tpu_torch.models.sdf import SDFNet
    make_synthetic_subject(str(root), n_frames=4, H=32, W=32, verbose=False,
                           device="cpu")
    cache = root / "initial_sdf_idr_6_1_torch.pt"
    torch.save(SDFNet(multires=6, bias=0.5, seed=1).state_dict(), cache)
    return cache


def check_results(results, labels):
    assert [r["label"] for r in results] == labels
    for r in results:
        assert math.isfinite(r["maskE"]) and 0.0 <= r["maskE"] <= 1.0, r
        assert 0.0 <= r["ray_frac"] <= 1.0, r
        assert all(math.isfinite(r[k]) for k in
                   ("loss", "mask_loss", "color_loss", "s_per_it")), r


def test_ab_stage_resume_on_cpu(tmp_path, capsys):
    """coarse.pt of a train-CLI run whose medium stage starts at epoch 1,
    resumed into 1 medium epoch (4 frames, N = 2: 2 steps) with base and
    ref_exact; each variant's fields reach the trainer's stage."""
    from selfreconcode_tpu_torch.cli import train as cli

    scene = tmp_path / "subject"
    subject_with_igr_cache(scene)
    conf = open(osp.join(REPO, "configs", "config.conf")).read()
    assert conf.count("start_epoch = 6") == 1
    (tmp_path / "c.conf").write_text(
        conf.replace("start_epoch = 6", "start_epoch = 1"))
    res = {s: RES for s in ("coarse", "medium", "fine")}
    cli.main(["--conf", str(tmp_path / "c.conf"), "--data", str(scene),
              "--save-folder", "rec", "--synthetic-body", "--max-epochs", "1",
              "--device", "cpu"], resolutions=res, skinner_res=(17, 29, 9),
             tune=small_counts)
    assert (scene / "rec" / "coarse.pt").is_file()
    trainers = []

    def tune(tr):
        small_counts(tr)
        trainers.append(tr)

    results = ABR.main(["--root", str(scene), "--ckpt", "coarse.pt",
                        "--stage", "medium", "--epochs", "1",
                        "--eval-frames", "2", "--variants", "base",
                        "ref_exact", "--device", "cpu"],
                       resolutions=res, tune=tune)
    check_results(results, ["base", "ref_exact"])
    assert [r["steps"] for r in results] == [2, 2]
    assert all(r["stage"] == "medium" for r in results)
    base, exact = (t.stage_cfg for t in trainers)
    assert (base.point_inits, base.anchor_sub, base.surf_newton) == (
        True, 256, True)
    assert (exact.point_inits, exact.anchor_sub, exact.surf_newton) == (
        False, 0, False)
    assert base.N == 2 and base.radius == 0.00465
    out = capsys.readouterr().out
    assert "| variant | maskE | loss | ray_frac |" in out
    assert "resumed coarse.pt (epoch 1) -> stage medium" in out


def test_ab_convergence_on_cpu(tmp_path, capsys):
    """Through the tool's entry point: the subject rendered into --root, the
    IGR cache read from the train CLI's name there, --conf read (its coarse
    batch cut from 3 frames to 2), then two coarse steps of base and
    cauchy."""
    from selfreconcode_tpu_torch.models.sdf import SDFNet

    conf = open(osp.join(REPO, "configs", "config.conf")).read()
    assert conf.count("batch_size = 3") == 1
    (tmp_path / "c.conf").write_text(
        conf.replace("batch_size = 3", "batch_size = 2"))
    (tmp_path / "subject").mkdir()
    torch.save(SDFNet(multires=6, bias=0.5, seed=1).state_dict(),
               tmp_path / "subject" / "initial_sdf_idr_6_1_torch.pt")
    trainers = []

    def tune(tr):
        small_counts(tr)
        trainers.append(tr)

    results = AB.main(["--steps", "2", "--variants", "base", "cauchy",
                       "--h", "32", "--frames", "4",
                       "--root", str(tmp_path / "subject"),
                       "--conf", str(tmp_path / "c.conf"), "--device", "cpu"],
                      resolutions={s: RES for s in
                                   ("coarse", "medium", "fine")},
                      skinner_res=(17, 29, 9), tune=tune)
    check_results(results, ["base", "cauchy"])
    assert [r["steps"] for r in results] == [2, 2]
    assert [len(r["rays"]) for r in results] == [2, 2]
    assert [t.stage_cfg.N for t in trainers] == [2, 2]
    assert [t.stage_cfg.surf_newton for t in trainers] == [True, False]
    assert all(t.timings["igr"] == 0.0 for t in trainers)
    out = capsys.readouterr().out
    assert "rendering A/B subject" in out
    assert "| variant | IoU | loss | ray_frac |" in out


@pytest.mark.parametrize("tool,argv", [(AB, []),
                                       (ABR, ["--root", "nowhere"])])
def test_ab_tools_refuse_to_run_without_cuda(tool, argv):
    """Both default to --device cuda and do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
