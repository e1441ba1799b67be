"""Parity of the port's surface points (Newton, and the reference's Cauchy
step with newton=False) and their IFT gradient with the JAX
``make_surface_points_fn``, and a finite-difference check of the port's
gradient against the exact root (as tests/test_surface.py does for JAX).

Tolerances: Newton points 1e-5 absolute (same iteration, float32); IFT
gradients 1e-4 relative to each leaf's largest entry, for either solver (the
backward solves a 3x3 system per ray and sums over rays in another order).
Cauchy points after 1-3 iterations within 1e-6 of the scene's scale (the
largest |coordinate| of the start points) with identical done masks; after
10 iterations the |sdf| kink and the 2-cycle of the ray term amplify
rounding, so the done masks agree on >= 99% of the rays and the points
within 1e-5 of the scale where both solvers converged.  The Cauchy cases
start 1e-3 off each ray (the fixture says why).  A ray whose convergence
test flips by rounding freezes one iteration apart in the two solvers, at
another point of its 2-cycle: with start points 5e-4 off their rays one
ray did, its two points 2.7e-5 apart, past the point tolerance; at 1e-3
none does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.engine import surface as JSURF
from selfreconcode_tpu.models import deformer as JD
from selfreconcode_tpu.models import sdf as JSDF
from selfreconcode_tpu.models import skinner as JSK
from selfreconcode_tpu.models import smpl as JSMPL
from selfreconcode_tpu.models import translator as JT
from selfreconcode_tpu_torch.engine.surface import (
    SurfaceConfig, optimize_surface_points, surface_points)
from selfreconcode_tpu_torch.interop import params_from_jax
from selfreconcode_tpu_torch.models.deformer import deformer_apply
from selfreconcode_tpu_torch.models.sdf import SDFNet
from selfreconcode_tpu_torch.models.skinner import Skinner
from selfreconcode_tpu_torch.models.translator import TranslatorNet

WRT = ("dcond", "poses", "trans", "rays", "cam_c")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_skinner(jsk) -> Skinner:
    t = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    return Skinner(ws=t(jsk.ws), ws_dims=tuple(jsk.ws_dims), b_min=t(jsk.b_min),
                   b_max=t(jsk.b_max), joints=t(jsk.joints),
                   init_pose_inv=t(jsk.init_pose_inv),
                   parents=tuple(jsk.parents))


@pytest.fixture(scope="module")
def setup():
    jnet = JSDF.SDFNet(hidden=(64,) * 4, skip_in=(2,), multires=2)
    jsp = JSDF.init_sdf_params(jax.random.PRNGKey(0), jnet)
    tnet_j = JT.TranslatorNet(cond_size=8, multires=2, hidden=(64, 64))
    jtp = JT.init_translator_params(jax.random.PRNGKey(1), tnet_j)
    jsk, _, _ = JSK.build_skinner(JSMPL.toy_smpl_model(n_verts=200),
                                  jnp.zeros(10), JSMPL.smpl_tmp_apose(0),
                                  resolution=(9, 17, 9),
                                  table_dtype=jnp.float32)
    jdef = JD.Deformer(translator=tnet_j, skinner=jsk)
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"sdf": jsp, "trans": jtp, "render": []}))
    sdf = SDFNet(hidden=(64,) * 4, skip_in=(2,), multires=2, seed=None)
    sdf.load_state_dict({k[4:]: torch.tensor(v) for k, v in sd.items()
                         if k.startswith("sdf.")})
    tnet = TranslatorNet(cond_size=8, multires=2, hidden=(64, 64), seed=None)
    tnet.load_state_dict({k[16:]: torch.tensor(v) for k, v in sd.items()
                          if k.startswith("deformer.defs.0.")})
    skinner = port_skinner(jsk)

    B, P, C = 2, 24, 96
    rng = np.random.default_rng(3)
    # candidate points on the camera-facing side (camera at z = -3)
    dirs = rng.standard_normal((C, 3)).astype(np.float32)
    dirs[:, 2] = -(1.0 + rng.random(C)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lo, hi = np.full(C, 0.05, np.float32), np.full(C, 1.2, np.float32)
    for _ in range(40):                    # bisect to the zero crossing
        mid = (lo + hi) / 2
        s = np.asarray(JSDF.sdf_value_only(jsp, jnet,
                                           jnp.asarray(dirs * mid[:, None]),
                                           1.0))
        lo, hi = np.where(s < 0, mid, lo), np.where(s >= 0, mid, hi)
    init = (dirs * ((lo + hi) / 2)[:, None]
            + 5e-4 * rng.standard_normal((C, 3))).astype(np.float32)
    binds = rng.integers(0, B, C).astype(np.int32)
    dcond = (0.01 * rng.standard_normal((B, 8))).astype(np.float32)
    poses = (0.02 * rng.standard_normal((B, 24, 3))).astype(np.float32)
    trans = (0.1 * rng.standard_normal((B, 3))).astype(np.float32)
    cam_c = np.array([0.0, 0.0, -3.0], np.float32)
    dd, _ = JD.deformer_apply(jtp, jdef, jnp.asarray(init), jnp.asarray(binds),
                              jnp.asarray(dcond), jnp.asarray(poses),
                              jnp.asarray(trans), 1.0)
    rays = np.asarray(dd) - cam_c
    rays = (rays / np.linalg.norm(rays, axis=1, keepdims=True)).astype(
        np.float32)
    # keep rays whose Gauss-Newton system is well conditioned: a ray that
    # grazes the surface gives cond(B^T B) ~ 1e4, and the IFT solve then
    # amplifies float32 noise (forward vs reverse mode sdf_grad) past 1e-4
    _, Bm, _, _ = JSURF._constraint_and_B(
        jsp, jtp, jnet, jdef, jnp.asarray(init), jnp.asarray(binds),
        jnp.asarray(dcond), jnp.asarray(poses), jnp.asarray(trans),
        jnp.asarray(rays), jnp.asarray(cam_c), 1.0, 1.0)
    Bm = np.asarray(Bm, np.float64)
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", Bm, Bm))
    keep = np.nonzero(ev[:, -1] / ev[:, 0] < 100.0)[0][:P]
    assert keep.size == P
    init, binds, rays = init[keep], binds[keep], rays[keep]
    d = dict(init=init, binds=binds, dcond=dcond, poses=poses, trans=trans,
             cam_c=cam_c, rays=rays)
    d["target"] = rng.standard_normal((P, 3)).astype(np.float32)
    # the Cauchy solve's start points: the rays pass through D(init), where
    # sin(angle) ~ 1e-8 and the gradient of |(D - c) x v| points along
    # float noise (the norm's kink at 0), so its steps would compare noise;
    # 1e-3 off the ray (~0.2 px at 512^2 from 2.5 m) the term is smooth
    d["init_off"] = (init + 1e-3 * rng.standard_normal((P, 3))).astype(
        np.float32)
    return jnet, jsp, tnet_j, jtp, jdef, sdf, tnet, skinner, d


def jax_run(setup, newton=True, init="init"):
    jnet, jsp, tnet_j, jtp, jdef, *_, d = setup
    cfg = JSURF.SurfaceConfig(n_iters=10, newton=newton)
    fn = JSURF.make_surface_points_fn(jnet, tnet_j, cfg)
    ratios = jnp.asarray([1.0, 1.0])
    args = {k: jnp.asarray(d[k]) for k in WRT}

    def loss(sp, tp, dcond, poses, trans, rays, cam_c):
        pts, done = fn(ratios, jdef, sp, tp, dcond, poses, trans, rays, cam_c,
                       jnp.asarray(d[init]), jnp.asarray(d["binds"]))
        w0 = jax.lax.stop_gradient(done).astype(jnp.float32)[:, None]
        return (w0 * pts * d["target"]).sum(), (pts, done)

    (_, (pts, done)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(7)), has_aux=True)(
        jsp, jtp, *(args[k] for k in WRT))
    return np.asarray(pts), np.asarray(done), grads


def port_leaves(d):
    return {k: torch.tensor(d[k], requires_grad=True) for k in WRT}


def port_run(setup, cfg=SurfaceConfig(n_iters=10), leaves=None, init="init"):
    *_, sdf, tnet, skinner, d = setup
    lv = leaves if leaves is not None else port_leaves(d)
    pts, done = surface_points((sdf, tnet, skinner), cfg, 1.0, 1.0,
                               lv["dcond"], lv["poses"], lv["trans"],
                               lv["rays"], lv["cam_c"],
                               torch.tensor(d[init]),
                               torch.tensor(d["binds"]).long())
    return pts, done, lv


def test_newton_points_and_converged_mask(setup):
    jpts, jdone, _ = jax_run(setup)
    pts, done, _ = port_run(setup)
    assert jdone.sum() >= 0.7 * len(jdone)
    np.testing.assert_array_equal(done.numpy(), jdone)
    np.testing.assert_allclose(pts.detach().numpy()[jdone], jpts[jdone],
                               atol=1e-5)


def check_ift_gradients(setup, newton, init):
    *_, sdf, tnet, skinner, d = setup
    _, jdone, jg = jax_run(setup, newton, init)
    for net in (sdf, tnet):
        net.zero_grad()
    pts, done, lv = port_run(setup, SurfaceConfig(n_iters=10, newton=newton),
                             init=init)
    np.testing.assert_array_equal(done.numpy(), jdone)
    assert jdone.any()
    w0 = done.float()[:, None]
    (w0 * pts * torch.tensor(d["target"])).sum().backward()

    def check(ref, mine):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.detach().numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-6))

    jsg, jtg = jg[0], jg[1]
    for l, layer in enumerate(jsg):
        lin = getattr(sdf, f"lin{l}")
        check(layer["v"], lin.weight_v.grad)
        check(np.asarray(layer["g"]).reshape(-1, 1), lin.weight_g.grad)
        check(layer["b"], lin.bias.grad)
    for l, layer in enumerate(jtg):
        check(layer["w"], getattr(tnet, f"lin{l}").weight.grad)
        check(layer["b"], getattr(tnet, f"lin{l}").bias.grad)
    for k, ref in zip(WRT, jg[2:]):
        check(ref, lv[k].grad)


def test_ift_gradients_match_jax(setup):
    check_ift_gradients(setup, newton=True, init="init")


def test_ift_gradients_match_jax_at_the_cauchy_point(setup):
    """JAX's backward rebuilds B at the solver's point whichever solver
    ran; the port's correction does the same at the Cauchy point."""
    check_ift_gradients(setup, newton=False, init="init_off")


def cauchy_points(setup, n_iters):
    """JAX's and the port's Cauchy solve (optimize_surface_points, no
    gradient) from the same start points: ((pts, done) JAX, port)."""
    jnet, jsp, tnet_j, jtp, jdef, sdf, tnet, skinner, d = setup
    j = JSURF.optimize_surface_points(
        jsp, jtp, jnet, jdef, jnp.asarray(d["init_off"]),
        jnp.asarray(d["binds"]),
        *(jnp.asarray(d[k]) for k in WRT), 1.0, 1.0,
        JSURF.SurfaceConfig(n_iters=n_iters, newton=False))
    t = optimize_surface_points(
        (sdf, tnet, skinner), SurfaceConfig(n_iters=n_iters, newton=False),
        1.0, 1.0, *(torch.tensor(d[k]) for k in WRT),
        torch.tensor(d["init_off"]), torch.tensor(d["binds"]).long())
    return ((np.asarray(j[0]), np.asarray(j[1])),
            (t[0].numpy(), t[1].numpy()))


@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_cauchy_first_iterations_match_jax(setup, n_iters):
    *_, d = setup
    scale = float(np.abs(d["init_off"]).max())
    (jpts, jdone), (pts, done) = cauchy_points(setup, n_iters)
    np.testing.assert_array_equal(done, jdone)
    np.testing.assert_allclose(pts, jpts, rtol=0, atol=1e-6 * scale)
    # the points moved: a solve, not the start points handed back
    assert np.abs(pts - d["init_off"]).max() > 1e-4 * scale


def test_cauchy_ten_iterations_match_jax(setup):
    *_, d = setup
    scale = float(np.abs(d["init_off"]).max())
    (jpts, jdone), (pts, done) = cauchy_points(setup, 10)
    assert (done == jdone).mean() >= 0.99
    both = done & jdone
    assert both.any()
    np.testing.assert_allclose(pts[both], jpts[both], rtol=0,
                               atol=1e-5 * scale)


def test_cauchy_early_exit_is_the_same_solve(setup):
    """early_exit stops the Cauchy loop once every ray has converged; done
    rays no longer move, so points and masks equal the fixed-count loop's
    (loose thresholds, so that every ray converges within the 10)."""
    *_, sdf, tnet, skinner, d = setup
    args = ((sdf, tnet, skinner),)
    rest = (1.0, 1.0, *(torch.tensor(d[k]) for k in WRT),
            torch.tensor(d["init_off"]), torch.tensor(d["binds"]).long())
    kw = dict(n_iters=10, newton=False, dthreshold=1e-2, athreshold_deg=2.0)
    full = optimize_surface_points(*args, SurfaceConfig(**kw), *rest)
    early = optimize_surface_points(
        *args, SurfaceConfig(**kw, early_exit=True), *rest)
    assert bool(full[1].all())
    assert torch.equal(full[0], early[0]) and torch.equal(full[1], early[1])


@pytest.mark.parametrize("wrt", ["dcond", "trans", "cam_c", "rays"])
def test_ift_gradient_matches_finite_differences(setup, wrt):
    """The IFT gradient is the gradient of the EXACT root: compare with
    central differences of a no-freeze, 20-iteration solve."""
    *_, d = setup
    pts, done, lv = port_run(setup)
    w0 = done.detach().float()[:, None]
    target = torch.tensor(d["target"])
    (w0 * pts * target).sum().backward()
    g = lv[wrt].grad.numpy().ravel()
    exact = SurfaceConfig(n_iters=20, dthreshold=-1.0, athreshold_deg=-1.0)

    def loss_at(flat):
        leaves = port_leaves(d)
        leaves[wrt] = torch.tensor(flat.reshape(d[wrt].shape))
        p, _, _ = port_run(setup, exact, leaves)
        return float((w0 * p.detach() * target).sum())

    x0 = d[wrt].astype(np.float64).ravel()
    rng = np.random.default_rng(11)
    eps, rel = 1e-3, []
    for i in rng.choice(x0.size, size=min(6, x0.size), replace=False):
        e = np.zeros_like(x0)
        e[i] = eps
        fd = (loss_at((x0 + e).astype(np.float32))
              - loss_at((x0 - e).astype(np.float32))) / (2 * eps)
        if abs(fd) < 1e-3 and abs(g[i]) < 1e-3:
            continue
        rel.append(abs(fd - g[i]) / max(abs(fd), abs(g[i]), 1e-2))
    assert rel, f"no informative coordinate for {wrt}"
    assert np.median(rel) < 0.2 and max(rel) < 0.9, (wrt, rel)


def test_value_is_the_newton_point(setup):
    """pts* + (corr - corr.detach()) keeps pts*'s value exactly."""
    *_, sdf, tnet, skinner, d = setup
    pts, done, lv = port_run(setup)
    with torch.no_grad():
        dv, _ = deformer_apply(tnet, skinner, pts, torch.tensor(d["binds"]).long(),
                               lv["dcond"], lv["poses"], lv["trans"], 1.0)
        s = sdf(pts, 1.0)[0]
    assert float(s[done].abs().max()) < 5e-5
    assert torch.isfinite(dv).all()
