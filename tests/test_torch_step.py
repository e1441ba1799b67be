"""The slice as a whole: one training step of the port against one
``make_train_step`` call of the JAX package, and the port's train CLI.

Both sides get narrow nets (JAX weights carried across), the same 32x32
synthetic scene, N = 1, the template from the JAX remesh (sliced to nv),
the same normal maps, and the same random draws: the test reproduces JAX's
key splits (trainer.py:612, :571, :332) and hands the port the uniform and
normal draws.  Sizes keep every top-k among valid entries (valid pixels
>= P, template verts >= eik_tmp, anchor over all verts), where lax.top_k
and torch.topk agree.

Three more variants of the same step: the three mesh regularizers on (the
config's coarse magnitudes made positive: Laplacian 10, edge 10, normal
consistency 0.001; the JAX template gets its host-built edge topology), ray
seeding by rasterized fragments (point_inits=False, raster footprint 10:
JAX's Pallas rasterizer in interpret mode, the port's plain version), and
the reference's Cauchy surface solve (surf_newton=False), alone and with
fragment seeds.  On the 32x32 scene the Cauchy solve from vertex seeds
converges none of the 32 rays in 10 iterations on either side (Newton:
all 32): a vertex seed lies up to half a 32 px pixel off its ray, and the
step's ray term is ~10x weaker than its sdf term.  From fragment seeds on
the 40x40 scene it converges 1 of 32 on both sides, so
test_cauchy_step_gradients_match holds the IFT gradient at a Cauchy point
through the whole step; test_torch_surface.py holds it ray by ray.

Tolerances: every info loss 1e-4 relative; the summed inner + outer
gradient before Adam 1e-3 * max|g| per leaf (float32 sums in another order
through a Newton solve, double backward and the splat); ray_converged within
1% of P (threshold flips from summation order); parameters after the step
where |g| > 1e-6 * max|g| (Adam's first step maps any nonzero g to +-lr, so
near-zero gradients may flip sign); the template after its SGD step 1e-6;
fragment face ids identical and the fragment seeds 2e-6 (on identical
vertices the two rasterizers' barycentrics differ by up to 3.6e-7, a few
float32 ulps, and a seed sums three vertices of norm up to ~1 with them).
"""
import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfreconcode_tpu.engine import surface as JSF
from selfreconcode_tpu.engine import trainer as JTR
from selfreconcode_tpu.models import deformer as JD
from selfreconcode_tpu.ops import rasterize as JRA
from selfreconcode_tpu.ops import sparse_sdf as JSS
from selfreconcode_tpu.utils import meshops as JM
from selfreconcode_tpu.utils.math import dct_null_space
from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.interop import (bank_from_jax, params_from_jax,
                                             params_to_jax)
from selfreconcode_tpu_torch.models.deformer import deformer_apply
from selfreconcode_tpu_torch.render.camera import make_camera
from test_torch_common import (H, NET_KW, W, _round, jax_scene, port_nets,
                               port_skinner, port_template)

import torch_dp_workers as DPW

P = 32
EIK = 512
RADIUS = 0.15          # 2.4 px: the Pallas (cs = 8) path in JAX
LR = 1e-3
REGULARIZERS = dict(laplacian_weight=10.0, edge_weight=10.0,
                    norm_weight=0.001)
VARIANTS = {"regularizers": {"weights": REGULARIZERS},
            "fragments": {"point_inits": False},
            "cauchy": {"surf_newton": False},
            "cauchy_fragments": {"point_inits": False, "surf_newton": False}}
# the fragment variants' scene: a 9^3 sweep over [-1, 1]^3 (156 vertices,
# so EIK 128) seen at 40x40, where JAX's Pallas rasterizer drops no face
# (its 256-entry cells overflow on the 33^3 template at 32x32)
FRAGMENT_SCENE = dict(hw=40, res=((5, 5, 5), (9, 9, 9)), half=1.0, eik=128)
SCENES = {"fragments": FRAGMENT_SCENE, "cauchy_fragments": FRAGMENT_SCENE}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_setup(root, hw=H, res=None, half=0.8, eik=EIK):
    s = jax_scene(root, res=res, half=half, hw=hw)
    ds, res, nv = s["ds"], s["res"], s["nv"]
    nw = min(30, ds.frame_num - 1)
    s["cfg"] = JTR.StageStatic(
        name="coarse", N=1, H=hw, W=hw, sample_pix=P, radius=RADIUS,
        remesh_intersect=30, vcap=s["vcap"], fcap=s["fcap"], ecap=1024,
        mc_active_cap=20000, resolutions=res,
        sweep_caps=tuple(JSS.default_caps(res)), raster_footprint=10,
        weights=JTR.LossWeights(), eik_tmp=eik, anchor_sub=0, window=nw,
        splat_cap=_round(nv, 64), splat_cells=256, splat_cap_max=4096,
        has_normals=True)
    s["dctnull"] = dct_null_space(min(10, max(1, nw // 3)), nw)
    return s


def recording_optimizer():
    """optax transformation whose state after update IS the gradient it was
    given (and whose updates are zero)."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        init=zeros, update=lambda g, s, p=None: (zeros(g), g))


def jax_draws(key, cfg, nv, vcap):
    k_sel, k_loss = jax.random.split(key)
    k_loss2, _ = jax.random.split(k_loss)
    k1, k2, k3 = jax.random.split(k_loss2, 3)
    S = P + cfg.eik_tmp
    k2a, k2b = jax.random.split(k2)
    k3a, _ = jax.random.split(k3)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return TTR.StepDraws(
        sel_scores=t(jax.random.uniform(k_sel, (cfg.N * cfg.H * cfg.W,))),
        eik_scores=t(jax.random.uniform(k1, (vcap,)))[:nv],
        eik_normal=t(jax.random.normal(k2a, (S, 3))),
        eik_uniform=t(jax.random.uniform(k2b, (S // 6, 3))),
        def_normal=t(jax.random.normal(k3a, (S, 3))),
        anchor_scores=None)


def with_jax_topology(tmp, nf):
    """The JAX template with its host-built edge topology, and without its
    padding faces: a padding face (0, 0, 0) has a zero normal, whose norm's
    VJP is 0/0, so JAX's normal-consistency gradient turns vertex 0 into NaN
    whenever faces are padded (a defect of the JAX package)."""
    faces = np.asarray(tmp.faces)[:nf]
    ne = JM.build_edge_topology(faces, nf, 3 * nf)["num_edges"]
    topo = JM.build_edge_topology(faces, nf, -(-ne // 1024) * 1024)
    return tmp._replace(faces=jnp.asarray(faces),
                        face_valid=jnp.ones(nf, bool),
                        **{k: jnp.asarray(topo[k]) for k in
                           ("edges", "edge_valid", "edge_faces", "ef_valid")})


def jax_step(root, variant=None, mesh=None):
    """One JAX step; variant names the stage fields of VARIANTS that both
    sides change.  mesh: JAX's data-parallel layout (``Trainer.set_mesh``):
    the image tensors sharded over their H axis, the state replicated.
    Returns its results and, under "port_in", the port's inputs."""
    s = jax_setup(root, **SCENES.get(variant, {}))
    ds, cfg, nv = s["ds"], s["cfg"], s["nv"]
    kw = dict(VARIANTS.get(variant, {}))
    if "weights" in kw:
        kw["weights"] = dataclasses.replace(cfg.weights, **kw["weights"])
        s["tmp"] = with_jax_topology(s["tmp"], s["nf"])
        kw["fcap"] = s["nf"]
    cfg = s["cfg"] = dataclasses.replace(cfg, **kw)
    assert nv >= cfg.eik_tmp
    fids = np.array([1])
    batch = ds.batch(fids)
    gtNs = np.random.default_rng(0).uniform(
        -1, 1, (1, cfg.H, cfg.W, 3)).astype(np.float32)
    windows, _ = ds.window_indices(fids, cfg.window)
    bank = jax.tree_util.tree_map(jnp.asarray, ds.param_bank())
    params = s["params"]
    key = jax.random.PRNGKey(42)
    ratios = jnp.asarray([1.0, 0.5, 1.0], jnp.float32)
    imgs = [jnp.asarray(batch["img"]), jnp.asarray(batch["mask"]),
            jnp.asarray(gtNs)]
    jdef = JD.Deformer(translator=s["nets"][1], skinner=s["jsk"])
    rec = recording_optimizer()
    jstep = JTR.make_train_step(*s["nets"], jdef, cfg, s["dctnull"], s["ang"],
                                rec)
    state = JTR.TrainState(params, bank, rec.init((params, bank)), s["tmp"])
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        rows = NamedSharding(mesh, PartitionSpec(None, "dp"))
        imgs = [jax.device_put(x, rows) for x in imgs]
        state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    new_state, jinfo = jstep(state, *imgs, jnp.asarray(fids, jnp.int32),
                             jnp.asarray(windows, jnp.int32), ratios,
                             jnp.asarray(LR), key)
    jg_params, jg_bank = new_state.opt_state
    adam = optax.adam(1.0)
    upd, _ = adam.update((jg_params, jg_bank), adam.init((params, bank)),
                         (params, bank))
    j_new_params = jax.tree_util.tree_map(lambda p, u: p + LR * u, params,
                                          upd[0])
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tcfg = TTR.StageStatic(
        name="coarse", N=1, H=cfg.H, W=cfg.W, sample_pix=P, radius=RADIUS,
        remesh_intersect=30, resolutions=cfg.resolutions,
        weights=TTR.LossWeights(**dataclasses.asdict(cfg.weights)),
        eik_tmp=cfg.eik_tmp, anchor_sub=0, window=cfg.window,
        has_normals=True, point_inits=cfg.point_inits,
        surf_newton=cfg.surf_newton, raster_footprint=cfg.raster_footprint)
    img, mask, nrm = TTR.image_batch({**batch, "normal": gtNs}, "cpu")
    port_in = dict(
        state_dict=params_from_jax(params_np), kwargs=NET_KW,
        bank=bank_from_jax(jax.tree_util.tree_map(np.asarray, bank)),
        cfg=tcfg, skinner=port_skinner(s["jsk"]),
        dctnull=np.asarray(s["dctnull"]), ang=float(s["ang"]), tmp=port_template(s), img=img, mask=mask, nrm=nrm,
        fids=torch.tensor(fids), windows=torch.tensor(windows), lr=LR,
        draws=jax_draws(key, cfg, nv, cfg.vcap))
    return dict(jinfo={k: float(v) for k, v in jinfo.items()},
                jg=(jg_params, jg_bank), j_new=j_new_params,
                j_tmp=new_state.tmp, params_np=params_np, nv=nv, s=s,
                fids=fids, port_in=port_in)


def run_step(root, variant=None):
    """One step of each side on the same inputs."""
    r = jax_step(root, variant)
    r.update(DPW.port_step(r["port_in"]), tmp0=r["port_in"]["tmp"])
    return r


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    return run_step(str(tmp_path_factory.mktemp("step")))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant_results(request, tmp_path_factory):
    return request.param, run_step(
        str(tmp_path_factory.mktemp(request.param)), request.param)


def test_step_losses_match(step_results):
    assert_losses_match(step_results)


def assert_losses_match(r):
    ji, ti = r["jinfo"], r["info"]
    keys = ("loss", "grad_loss", "def_loss", "dct_loss", "color_loss",
            "normal_loss", "pc_loss_sdf", "pc_mask_loss", "pc_defconst_loss",
            "pred_mask_sum", "inv_ok")
    for k in keys:
        assert k in ti, k
        np.testing.assert_allclose(ti[k], ji[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert ji["inv_ok"] == P
    assert abs(ti["ray_converged"] - ji["ray_converged"]) <= 0.01 * P
    # the port drops no splat: it has no overflow to report
    assert "splat_overflow" not in ti and ji["splat_overflow"] == 0


def test_variant_steps_match(variant_results):
    """The regularizer, fragment-seeding and Cauchy variants: every loss
    (the new pc_lap/edge/norm losses included) and the template after its
    SGD step."""
    variant, r = variant_results
    ji, ti = r["jinfo"], r["info"]
    new = (("pc_lap_loss", "pc_edge_loss", "pc_norm_loss")
           if variant == "regularizers" else ())
    for k in new:
        assert ti[k] > 0
    for k in new + ("loss", "grad_loss", "def_loss", "color_loss",
                    "normal_loss", "pc_loss_sdf", "pc_mask_loss",
                    "pc_defconst_loss", "inv_ok"):
        np.testing.assert_allclose(ti[k], ji[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert abs(ti["ray_converged"] - ji["ray_converged"]) <= 0.01 * P
    assert ji["frag_overflow"] == 0
    np.testing.assert_allclose(r["tmp"].verts.numpy(),
                               np.asarray(r["j_tmp"].verts)[:r["nv"]],
                               atol=1e-6)
    if variant == "regularizers":
        # the regularizers move the template: the SGD step saw them
        assert not np.allclose(r["tmp"].momentum.numpy(), 0.0)


@pytest.mark.parametrize("variant_results", ["fragments"], indirect=True)
def test_fragment_seeds_match_jax(variant_results):
    """The geom pass's fragment seeding on the step's deformed template:
    JAX's rasterize_mesh + surface_inits_from_fragments against the port's
    fragment_seeds."""
    _, r = variant_results
    s, fids, tmp = r["s"], r["fids"], r["tmp0"]
    ds, cfg, vcap = s["ds"], s["cfg"], s["vcap"]
    jbank = jax.tree_util.tree_map(jnp.asarray, ds.param_bank())
    jdef = JD.Deformer(translator=s["nets"][1], skinner=s["jsk"])
    f = int(fids[0])
    jdv, _ = JD.deformer_apply(
        s["params"]["trans"], jdef, s["tmp"].verts, jnp.zeros(vcap, jnp.int32),
        jbank["cond_deformer"][f:f + 1], jbank["poses"][f:f + 1],
        jbank["trans"][f:f + 1], 0.5)
    jcam = JTR.camera_from_bank(jbank, cfg.H, cfg.W, cfg)
    frags = JRA.rasterize_mesh(jcam, jdv, s["tmp"].faces, s["tmp"].face_valid,
                               cfg.raster_footprint)
    assert int(frags.overflow) == 0
    jinit, jvalid = JSF.surface_inits_from_fragments(
        s["tmp"].verts, s["tmp"].faces, frags.pix_to_face, frags.bary)
    # the nets and the bank as they were before the step's Adam update
    tbank = {k: torch.tensor(v) for k, v in bank_from_jax(
        jax.tree_util.tree_map(np.asarray, jbank)).items()}
    with torch.no_grad():
        tdv, _ = deformer_apply(
            port_nets(r["params_np"]).translator, port_skinner(s["jsk"]),
            tmp.verts, torch.zeros(r["nv"], dtype=torch.long),
            tbank["dcond"][f:f + 1], tbank["poses"][f:f + 1],
            tbank["trans"][f:f + 1], 0.5)
        tcam = make_camera(*(tbank[k] for k in (
            "focal_length", "princeple_points", "cam2world_coord_quat",
            "world2cam_coord_trans")), cfg.H, cfg.W)
        tinit, tvalid, p2f = TTR.fragment_seeds(tcam, tmp.verts, tmp.faces,
                                                tdv[None],
                                                cfg.raster_footprint)
    np.testing.assert_array_equal(p2f[0].numpy(),
                                  np.asarray(frags.pix_to_face))
    assert tvalid.sum() > P
    np.testing.assert_array_equal(tvalid[0].numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tinit[0].numpy(), np.asarray(jinit),
                               rtol=0, atol=2e-6)


def test_template_sgd_matches(step_results):
    assert_template_matches(step_results)


def assert_template_matches(r):
    nv = r["nv"]
    jt = r["j_tmp"]
    np.testing.assert_allclose(r["tmp"].verts.numpy(),
                               np.asarray(jt.verts)[:nv], atol=1e-6)
    m = np.asarray(jt.momentum)[:nv]
    np.testing.assert_allclose(r["tmp"].momentum.numpy(), m,
                               rtol=0, atol=1e-3 * np.abs(m).max())


def _port_grads(r):
    g = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
         for k, v in r["nets"].state_dict(keep_vars=True).items()}
    return params_to_jax(g)


def test_summed_gradients_match(step_results):
    assert_gradients_match(step_results)


@pytest.mark.parametrize("variant_results", ["cauchy_fragments"],
                         indirect=True)
def test_cauchy_step_gradients_match(variant_results):
    """Fragment-seeded Cauchy points, some converged on both sides, so the
    IFT gradient at a Cauchy point enters the compared gradients."""
    _, r = variant_results
    assert r["info"]["ray_converged"] > 0 and r["jinfo"]["ray_converged"] > 0
    assert_gradients_match(r)


def assert_gradients_match(r):
    """The summed inner + outer gradient before Adam, per leaf."""
    jg_params, jg_bank = r["jg"]
    mine = _port_grads(r)
    for tower in ("sdf", "trans", "render"):
        for l, (a, b) in enumerate(zip(jg_params[tower], mine[tower])):
            for name in a:
                ref = np.asarray(a[name]).reshape(b[name].shape)
                np.testing.assert_allclose(
                    b[name], ref, rtol=0,
                    atol=1e-3 * max(np.abs(ref).max(), 1e-12),
                    err_msg=f"{tower}[{l}].{name}")
    tb = r["bank"]
    ref_bank = bank_from_jax(jax.tree_util.tree_map(np.asarray, jg_bank))
    for k, ref in ref_bank.items():
        g = tb[k].grad
        g = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=1e-3 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=k)


def test_params_after_adam_match(step_results):
    assert_params_match(step_results)


def assert_params_match(r):
    jg_params, _ = r["jg"]
    mine_new = params_to_jax(r["nets"].state_dict())
    for tower in ("sdf", "trans", "render"):
        for a, b, g in zip(r["j_new"][tower], mine_new[tower],
                           jg_params[tower]):
            for name in a:
                gg = np.abs(np.asarray(g[name])).reshape(b[name].shape)
                sel = gg > 1e-6 * gg.max()
                ref = np.asarray(a[name]).reshape(b[name].shape)
                np.testing.assert_allclose(b[name][sel], ref[sel], rtol=0,
                                           atol=0.05 * LR)


def test_train_cli_on_cpu(tmp_path):
    """Port-only: cli.train.main end to end on a 32x32 toy scene.  30 IGR
    iterations at full width (fewer leave the field entirely negative, so
    the remesh finds no surface); tiny octree and skinner.  The parser
    rejects --gpu-ids and a malformed --mesh, and reads --mesh dp=N
    (test_torch_parallel.py trains with it)."""
    from selfreconcode_tpu_torch.cli import train as cli
    from selfreconcode_tpu_torch.data.dataset import \
        make_synthetic_scene as port_scene

    scene = tmp_path / "scene"
    port_scene(str(scene), n_frames=4, H=H, W=W)
    conf = open(osp.join(osp.dirname(__file__), "..", "configs",
                         "config.conf")).read()
    conf = conf.replace("initial_iters = -1200", "initial_iters = -30")
    (tmp_path / "c.conf").write_text(conf)
    res = [(9, 9, 9), (17, 17, 17)]

    def tune(tr):
        tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                          surf_iters=4)

    tr = cli.main(["--conf", str(tmp_path / "c.conf"), "--data", str(scene),
                   "--save-folder", "rec", "--toy-smpl", "--max-epochs", "0",
                   "--device", "cpu"],
                  resolutions={s: res for s in ("coarse", "medium", "fine")},
                  skinner_res=(17, 29, 9), tune=tune)
    assert len(tr.history) == 1                     # 4 frames, batch 3
    assert all(np.isfinite(v) for v in tr.history[0].values())
    assert (scene / "rec" / "latest.pt").is_file()
    assert (scene / "initial_sdf_idr_6_1_torch.pt").is_file()
    assert (scene / "initial_skinner_1_torch.pt").is_file()
    base = ["--conf", "c", "--data", "d", "--save-folder", "s"]
    for bad in (["--gpu-ids", "0"], ["--mesh", "dp=x"]):
        with pytest.raises(SystemExit):
            cli.parse_args(base + bad)
    assert cli.parse_args(base + ["--mesh", "dp=2"]).dp == 2


def _cli_conf(tmp_path, fine_at=None):
    """configs/config.conf with 30 IGR iterations (see above), and with the
    medium stage off and the fine stage from epoch fine_at if given."""
    conf = open(osp.join(osp.dirname(__file__), "..", "configs",
                         "config.conf")).read()
    conf = conf.replace("initial_iters = -1200", "initial_iters = -30")
    if fine_at is not None:
        conf = conf.replace("start_epoch = 6", "start_epoch = -1")
        conf = conf.replace("start_epoch = 12", f"start_epoch = {fine_at}")
    path = tmp_path / "c.conf"
    path.write_text(conf)
    return str(path)


def _tune(tr):
    """Small sample counts for a CPU run, in any stage (the fine stage's
    loss block sets its own ray count)."""
    tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                      surf_iters=2, weights=dataclasses.replace(
                          tr.stage_cfg.weights, sample_pix_num=0))


def test_train_cli_fine_stage_writes_debug_dump(tmp_path, monkeypatch):
    """Port-only: the train CLI with no body flag (the pickle of the scene's
    gender, found through $SMPL_MODEL_DIR: the toy body written in the
    asset's schema) and a conf whose fine stage starts at epoch 0: 3 fine
    steps (N = 1), and the debug dump right after the first
    (forward_time % remesh_intersect == 1)."""
    from selfreconcode_tpu_torch.cli import train as cli
    from selfreconcode_tpu_torch.data.dataset import \
        make_synthetic_scene as port_scene
    from selfreconcode_tpu_torch.models.smpl import toy_smpl_model
    from selfreconcode_tpu_torch.models.synthetic_body import \
        save_smpl_pickle

    scene = tmp_path / "scene"
    port_scene(str(scene), n_frames=3, H=H, W=W)
    argv = ["--conf", _cli_conf(tmp_path, fine_at=0), "--data", str(scene),
            "--save-folder", "rec", "--max-epochs", "0", "--device", "cpu"]
    res = {s: [(9, 9, 9), (17, 17, 17)] for s in ("coarse", "medium", "fine")}
    monkeypatch.delenv("SMPL_MODEL_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="neutral_smpl_with_cocoplus"):
        cli.main(argv, resolutions=res, skinner_res=(17, 29, 9))
    assets = tmp_path / "assets"
    assets.mkdir()
    save_smpl_pickle(toy_smpl_model(),
                     str(assets / "neutral_smpl_with_cocoplus_reg.pkl"))
    monkeypatch.setenv("SMPL_MODEL_DIR", str(assets))
    tr = cli.main(argv, resolutions=res, skinner_res=(17, 29, 9), tune=_tune)
    assert tr.stage_cfg.name == "fine" and tr.stage_cfg.N == 1
    assert len(tr.history) == 3 and tr.forward_time == 3
    assert all(np.isfinite(v) for h in tr.history for v in h.values())
    debug = scene / "rec" / "debug"
    names = sorted(p.name for p in debug.iterdir())
    assert names == sorted(["tmp.ply", "def_0.ply", "def1_0.ply", "m0.png",
                            "gm0.png", "rgb0.png", "n0.png"])
    nv = tr.tmp.verts.shape[0]
    head = (debug / "def_0.ply").read_text().splitlines()[:4]
    assert head[2] == f"element vertex {nv}"
    import cv2
    assert cv2.imread(str(debug / "rgb0.png")).shape == (H, W, 3)
    assert (scene / "rec" / "medium.pt").is_file()
    assert (scene / "initial_sdf_idr_6_1_torch.ply").is_file()


def test_train_cli_synthetic_body_on_cpu(tmp_path):
    """Port-only: --synthetic-body (the 6890-vertex body) on a 32x32 subject
    with normal maps: one coarse step, the normal loss included.  The IGR
    cache in the data root is the SDF's geometric init with bias 0.5 (a
    sphere of radius ~0.27, inside the body's sweep box), so the CLI skips
    IGR, whose 5000-point batches over the full-width net take minutes on
    one CPU thread."""
    from selfreconcode_tpu_torch.cli import train as cli
    from selfreconcode_tpu_torch.data.synthetic_subject import \
        make_synthetic_subject
    from selfreconcode_tpu_torch.models.sdf import SDFNet

    scene = tmp_path / "subject"
    make_synthetic_subject(str(scene), n_frames=4, H=H, W=W, verbose=False,
                           device="cpu")
    torch.save(SDFNet(multires=6, bias=0.5, seed=1).state_dict(),
               scene / "initial_sdf_idr_6_1_torch.pt")
    tr = cli.main(["--conf", _cli_conf(tmp_path), "--data", str(scene),
                   "--save-folder", "rec", "--synthetic-body",
                   "--max-epochs", "0", "--device", "cpu"],
                  resolutions={s: [(9, 9, 9), (17, 17, 17)]
                               for s in ("coarse", "medium", "fine")},
                  skinner_res=(17, 29, 9), tune=_tune)
    assert tr.body_vs.shape == (6890, 3)
    (info,) = tr.history
    assert np.isfinite(info["normal_loss"]) and info["normal_loss"] > 0
    assert all(np.isfinite(v) for v in info.values())
    assert (scene / "rec" / "latest.pt").is_file()
    assert not any((scene / "rec" / "debug").iterdir())
