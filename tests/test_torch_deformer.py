"""Parity of the port's body model, skinner and deformer with the JAX package.

Skinner built at (17, 29, 9) on toy_smpl_model(400) (the JAX table in
float32).  Tolerance 1e-5 relative, with an absolute floor of 1e-5 times the
tensor's largest entry: the same float32 formulas, sums in another order,
and the Jacobians cancel large terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.models import deformer as JD
from selfreconcode_tpu.models import skinner as JSK
from selfreconcode_tpu.models import smpl as JSMPL
from selfreconcode_tpu.models import translator as JT
from selfreconcode_tpu_torch.interop import params_from_jax
from selfreconcode_tpu_torch.models import smpl as TSMPL
from selfreconcode_tpu_torch.models.deformer import (deformer_apply,
                                                     deformer_jacobian)
from selfreconcode_tpu_torch.models.skinner import (build_skinner,
                                                    skinner_apply_shared)
from selfreconcode_tpu_torch.models.translator import TranslatorNet

RES = (17, 29, 9)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    shape = 0.3 * np.random.default_rng(0).normal(size=10).astype(np.float32)
    jsk, jvs, _ = JSK.build_skinner(JSMPL.toy_smpl_model(400),
                                    jnp.asarray(shape), JSMPL.smpl_tmp_apose(1),
                                    resolution=RES, table_dtype=jnp.float32)
    tsk, tvs, _ = build_skinner(TSMPL.toy_smpl_model(400), shape,
                                TSMPL.smpl_tmp_apose(1), resolution=RES)
    jnet = JT.TranslatorNet(cond_size=8, multires=4, hidden=(64, 64))
    jp = JT.init_translator_params(jax.random.PRNGKey(1), jnet)
    # a visibly non-identity translator so the Jacobian is non-trivial
    jp = jax.tree_util.tree_map(lambda x: 4.0 * x, jp)
    sd = params_from_jax({"sdf": [], "render": [],
                          "trans": jax.tree_util.tree_map(np.asarray, jp)})
    tnet = TranslatorNet(cond_size=8, multires=4, hidden=(64, 64), seed=None)
    tnet.load_state_dict({k[len("deformer.defs.0."):]: torch.tensor(v)
                          for k, v in sd.items()})
    rng = np.random.default_rng(1)
    B, N = 3, 120
    data = dict(
        pts=rng.normal(0, 0.3, (N, 3)).astype(np.float32),
        binds=rng.integers(0, B, N).astype(np.int32),
        dcond=rng.normal(0, 0.1, (B, 8)).astype(np.float32),
        poses=rng.normal(0, 0.2, (B, 24, 3)).astype(np.float32),
        trans=rng.normal(0, 0.1, (B, 3)).astype(np.float32))
    jdef = JD.Deformer(translator=jnet, skinner=jsk)
    return jsk, jvs, tsk, tvs, jp, jdef, tnet, data


def close(a, b, rtol=1e-5):
    a = np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol,
                               atol=rtol * max(float(np.abs(a).max()), 1.0))


def test_skinner_build(setup):
    jsk, jvs, tsk, tvs, *_ = setup
    close(jvs, tvs)
    close(jsk.b_min, tsk.b_min)
    close(jsk.b_max, tsk.b_max)
    close(jsk.joints, tsk.joints)
    close(jsk.init_pose_inv, tsk.init_pose_inv)
    assert tuple(jsk.ws_dims) == tuple(tsk.ws_dims)
    close(jsk.ws, tsk.ws)


def test_skinner_apply_shared(setup):
    jsk, _, tsk, _, _, _, _, d = setup
    j = JSK.skinner_apply_shared(jsk, jnp.asarray(d["pts"]),
                                 jnp.asarray(d["poses"]), jnp.asarray(d["trans"]))
    t = skinner_apply_shared(tsk, torch.tensor(d["pts"]),
                             torch.tensor(d["poses"]), torch.tensor(d["trans"]))
    close(j, t)


def _args(d, lib):
    cv = jnp.asarray if lib == "jax" else torch.tensor
    binds = (jnp.asarray(d["binds"]) if lib == "jax"
             else torch.tensor(d["binds"]).long())
    return (cv(d["pts"]), binds, cv(d["dcond"]), cv(d["poses"]),
            cv(d["trans"]))


def test_deformer_apply_and_jacobian(setup):
    _, _, tsk, _, jp, jdef, tnet, d = setup
    jo, joff = JD.deformer_apply(jp, jdef, *_args(d, "jax"), 0.8)
    to, toff = deformer_apply(tnet, tsk, *_args(d, "torch"), 0.8)
    close(jo, to.detach())
    close(joff, toff.detach())
    jj, jout = JD.deformer_jacobian(jp, jdef, *_args(d, "jax"), 0.8)
    tj, tout = deformer_jacobian(tnet, tsk, *_args(d, "torch"), 0.8)
    close(jj, tj.detach())
    close(jout, tout.detach())


def test_double_backward_through_jacobian(setup):
    """The normal loss differentiates through J: d/dtheta of a function of
    J(p), with p itself carrying a gradient."""
    _, _, tsk, _, jp, jdef, tnet, d = setup
    target = np.random.default_rng(7).normal(size=(120, 3, 3)).astype(
        np.float32)

    def jloss(params, pts):
        jj, _ = JD.deformer_jacobian(params, jdef, pts, jnp.asarray(d["binds"]),
                                     jnp.asarray(d["dcond"]),
                                     jnp.asarray(d["poses"]),
                                     jnp.asarray(d["trans"]), 0.8)
        return (jj * target).sum()

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(d["pts"]))
    pts, binds, dcond, poses, trans = _args(d, "torch")
    pts.requires_grad_(True)
    tj, _ = deformer_jacobian(tnet, tsk, pts, binds, dcond, poses, trans, 0.8)
    (tj * torch.tensor(target)).sum().backward()
    close(jg_x, pts.grad)
    for l, layer in enumerate(jg_p):
        close(layer["w"], getattr(tnet, f"lin{l}").weight.grad)


def test_posed_plane_stretches_as_in_jax():
    """Both deformers stretch the same faces ~7x.  The setting is the
    trainer's: the 800-vertex toy body, the A-pose canonical space
    (pose type 1, arms 55 degrees down), the full-width translator and a
    near-zero frame pose like the synthetic scene's.  The template is a
    1.5 cm grid over the body's front plane (14k vertices).  Where the
    template leaves the toy body's points, the diffused weights mix the hand
    (joint 22) with the knee (4).  The frame lifts the arm back up by 55
    degrees, so those 1.5 cm edges grow to ~15 cm.  The inference template
    on the card stretches the same way."""
    res = (33, 57, 17)
    jsk, _, _ = JSK.build_skinner(JSMPL.toy_smpl_model(), jnp.zeros(10),
                                  JSMPL.smpl_tmp_apose(1), resolution=res,
                                  table_dtype=jnp.float32)
    tsk, _, _ = build_skinner(TSMPL.toy_smpl_model(),
                              np.zeros(10, np.float32),
                              TSMPL.smpl_tmp_apose(1), resolution=res)
    xs, ys = np.arange(-0.8, 0.8001, 0.015), np.arange(-1.2, 0.8001, 0.015)
    X, Y = np.meshgrid(xs, ys)
    verts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], 1).astype(
        np.float32)
    nx = len(xs)
    i = (np.arange(len(ys) - 1)[:, None] * nx + np.arange(nx - 1)).ravel()
    faces = np.concatenate([np.stack([i, i + 1, i + nx], 1),
                            np.stack([i + 1, i + nx + 1, i + nx], 1)])
    d = dict(pts=verts, binds=np.zeros(len(verts), np.int32),
             dcond=np.zeros((1, 128), np.float32),
             poses=(0.03 * np.random.default_rng(0).standard_normal(
                 (1, 24, 3))).astype(np.float32),
             trans=np.array([[0.0, 0.0, 2.5]], np.float32))
    jnet = JT.TranslatorNet()
    jp = JT.init_translator_params(jax.random.PRNGKey(2), jnet)
    sd = params_from_jax({"sdf": [], "render": [],
                          "trans": jax.tree_util.tree_map(np.asarray, jp)})
    tnet = TranslatorNet(seed=None)
    tnet.load_state_dict({k[len("deformer.defs.0."):]: torch.tensor(v)
                          for k, v in sd.items()})
    jo, _ = JD.deformer_apply(jp, JD.Deformer(translator=jnet, skinner=jsk),
                              *_args(d, "jax"), 1.0)
    with torch.no_grad():
        to, _ = deformer_apply(tnet, tsk, *_args(d, "torch"), 1.0)
    close(jo, to)

    def edge_max(v):
        v = np.asarray(v)
        a, b, c = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
        return np.stack([np.linalg.norm(a - b, axis=1),
                         np.linalg.norm(b - c, axis=1),
                         np.linalg.norm(c - a, axis=1)], 1).max(1)

    e0, ej, et = edge_max(verts), edge_max(jo), edge_max(to.numpy())
    close(ej, et)
    assert (ej / e0).max() > 5 and (et / e0).max() > 5
    widest = verts[faces[np.argmax(et / e0)]].mean(0)
    assert abs(widest[0]) > 0.6 and -0.7 < widest[1] < -0.5, widest
