"""The slice as a whole: one training step of the port against one
``make_train_step`` call of the JAX package, and the port's train CLI.

Both sides get narrow nets (JAX weights carried across), the same 32x32
synthetic scene, N = 1, the template from the JAX remesh (sliced to nv),
the same normal maps, and the same random draws: the test reproduces JAX's
key splits (trainer.py:612, :571, :332) and hands the port the uniform and
normal draws.  Sizes keep every top-k among valid entries (valid pixels
>= P, template verts >= eik_tmp, anchor over all verts), where lax.top_k
and torch.topk agree.

Tolerances: every info loss 1e-4 relative; the summed inner + outer
gradient before Adam 1e-3 * max|g| per leaf (float32 sums in another order
through a Newton solve, double backward and the splat); ray_converged within
1% of P (threshold flips from summation order); parameters after the step
where |g| > 1e-6 * max|g| (Adam's first step maps any nonzero g to +-lr, so
near-zero gradients may flip sign).
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfreconcode_tpu.engine import trainer as JTR
from selfreconcode_tpu.models import deformer as JD
from selfreconcode_tpu.ops import sparse_sdf as JSS
from selfreconcode_tpu.utils.math import dct_null_space
from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.interop import bank_from_jax, params_to_jax
from test_torch_common import (H, W, _round, jax_scene, port_nets,
                               port_skinner, port_template)

P = 32
EIK = 512
RADIUS = 0.15          # 2.4 px: the Pallas (cs = 8) path in JAX
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_setup(root):
    s = jax_scene(root)
    ds, res, nv = s["ds"], s["res"], s["nv"]
    nw = min(30, ds.frame_num - 1)
    s["cfg"] = JTR.StageStatic(
        name="coarse", N=1, H=H, W=W, sample_pix=P, radius=RADIUS,
        remesh_intersect=30, vcap=s["vcap"], fcap=s["fcap"], ecap=1024,
        mc_active_cap=20000, resolutions=res,
        sweep_caps=tuple(JSS.default_caps(res)), raster_footprint=10,
        weights=JTR.LossWeights(), eik_tmp=EIK, anchor_sub=0, window=nw,
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
    S = P + EIK
    k2a, k2b = jax.random.split(k2)
    k3a, _ = jax.random.split(k3)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return TTR.StepDraws(
        sel_scores=t(jax.random.uniform(k_sel, (cfg.N * H * W,))),
        eik_scores=t(jax.random.uniform(k1, (vcap,)))[:nv],
        eik_normal=t(jax.random.normal(k2a, (S, 3))),
        eik_uniform=t(jax.random.uniform(k2b, (S // 6, 3))),
        def_normal=t(jax.random.normal(k3a, (S, 3))),
        anchor_scores=None)


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    s = jax_setup(str(tmp_path_factory.mktemp("step")))
    ds, cfg, nv = s["ds"], s["cfg"], s["nv"]
    assert nv >= EIK
    fids = np.array([1])
    batch = ds.batch(fids)
    gtNs = np.random.default_rng(0).uniform(-1, 1, (1, H, W, 3)).astype(
        np.float32)
    windows, _ = ds.window_indices(fids, cfg.window)
    bank = jax.tree_util.tree_map(jnp.asarray, ds.param_bank())
    params = s["params"]
    key = jax.random.PRNGKey(42)
    ratios = jnp.asarray([1.0, 0.5, 1.0], jnp.float32)
    args = (jnp.asarray(batch["img"]), jnp.asarray(batch["mask"]),
            jnp.asarray(gtNs), jnp.asarray(fids, jnp.int32),
            jnp.asarray(windows, jnp.int32), ratios, jnp.asarray(LR), key)
    jdef = JD.Deformer(translator=s["nets"][1], skinner=s["jsk"])
    rec = recording_optimizer()
    jstep = JTR.make_train_step(*s["nets"], jdef, cfg, s["dctnull"], s["ang"],
                                rec)
    state = JTR.TrainState(params, bank, rec.init((params, bank)), s["tmp"])
    new_state, jinfo = jstep(state, *args)
    jg_params, jg_bank = new_state.opt_state
    adam = optax.adam(1.0)
    upd, _ = adam.update((jg_params, jg_bank), adam.init((params, bank)),
                         (params, bank))
    j_new_params = jax.tree_util.tree_map(lambda p, u: p + LR * u, params,
                                          upd[0])
    # the port
    params_np = jax.tree_util.tree_map(np.asarray, params)
    nets = port_nets(params_np)
    tbank = {k: torch.tensor(v, requires_grad=True)
             for k, v in bank_from_jax(jax.tree_util.tree_map(
                 np.asarray, bank)).items()}
    opt = torch.optim.Adam(list(nets.parameters()) + list(tbank.values()),
                           lr=LR, betas=(0.9, 0.999), eps=1e-8)
    tcfg = TTR.StageStatic(
        name="coarse", N=1, H=H, W=W, sample_pix=P, radius=RADIUS,
        remesh_intersect=30, resolutions=cfg.resolutions,
        weights=TTR.LossWeights(), eik_tmp=EIK, anchor_sub=0,
        window=cfg.window, has_normals=True)
    tstep = TTR.make_train_step(nets, port_skinner(s["jsk"]), tcfg,
                                s["dctnull"], s["ang"], opt)
    tmp = port_template(s)
    img, mask, nrm = TTR.image_batch({**batch, "normal": gtNs}, "cpu")
    new_tmp, info = tstep(tbank, tmp, img, mask, nrm, torch.tensor(fids),
                          torch.tensor(windows), (1.0, 0.5, 1.0), LR,
                          jax_draws(key, cfg, nv, cfg.vcap))
    return dict(jinfo={k: float(v) for k, v in jinfo.items()}, info=info,
                jg=(jg_params, jg_bank), j_new=j_new_params,
                j_tmp=new_state.tmp, nets=nets, bank=tbank, tmp=new_tmp,
                params_np=params_np, nv=nv)


def test_step_losses_match(step_results):
    ji, ti = step_results["jinfo"], step_results["info"]
    keys = ("loss", "grad_loss", "def_loss", "dct_loss", "color_loss",
            "normal_loss", "pc_loss_sdf", "pc_mask_loss", "pc_defconst_loss",
            "pred_mask_sum", "inv_ok")
    for k in keys:
        assert k in ti, k
        np.testing.assert_allclose(ti[k], ji[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert ji["inv_ok"] == P
    assert abs(ti["ray_converged"] - ji["ray_converged"]) <= 0.01 * P
    assert ti["splat_overflow"] == 0 and ji["splat_overflow"] == 0


def test_template_sgd_matches(step_results):
    nv = step_results["nv"]
    jt = step_results["j_tmp"]
    np.testing.assert_allclose(step_results["tmp"].verts.numpy(),
                               np.asarray(jt.verts)[:nv], atol=1e-6)
    m = np.asarray(jt.momentum)[:nv]
    np.testing.assert_allclose(step_results["tmp"].momentum.numpy(), m,
                               rtol=0, atol=1e-3 * np.abs(m).max())


def _port_grads(r):
    g = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
         for k, v in r["nets"].state_dict(keep_vars=True).items()}
    return params_to_jax(g)


def test_summed_gradients_match(step_results):
    r = step_results
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
    r = step_results
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
    the remesh finds no surface); tiny octree and skinner."""
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
    with pytest.raises(SystemExit):
        cli.parse_args(["--conf", "c", "--data", "d", "--save-folder", "s",
                        "--mesh", "dp=2"])
