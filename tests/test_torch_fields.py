"""Parity of the port's three MLPs with the JAX package.

Weights are made by the JAX initializers and carried across with
``interop.params_from_jax``.  Tolerance 1e-5 relative for values; 1e-4 for
``sdf_grad``, which is forward mode in JAX and reverse mode here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.models import render as JR
from selfreconcode_tpu.models import sdf as JSDF
from selfreconcode_tpu.models import translator as JT
from selfreconcode_tpu_torch.interop import params_from_jax
from selfreconcode_tpu_torch.models.render import RenderNet
from selfreconcode_tpu_torch.models.sdf import SDFNet, sdf_grad
from selfreconcode_tpu_torch.models.translator import TranslatorNet
from selfreconcode_tpu_torch.utils.pe import (annealing_band_weights,
                                              positional_encoding)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(module, params_np, tower, prefix):
    sd = params_from_jax({"sdf": [], "trans": [], "render": [],
                          tower: params_np})
    module.load_state_dict({k[len(prefix) + 1:]: torch.tensor(v)
                            for k, v in sd.items()})
    return module


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("ratio", [None, 0.5, 1.0])
def test_sdf_value_feature_and_grad_narrow(ratio):
    jnet = JSDF.SDFNet(hidden=(64,) * 4, skip_in=(2,), feature_size=16)
    jp = JSDF.init_sdf_params(jax.random.PRNGKey(0), jnet)
    # perturb away from the geometric init so every input column matters
    jp = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(1),
                                               x.shape), jp)
    net = load(SDFNet(hidden=(64,) * 4, skip_in=(2,), feature_size=16,
                      seed=None), to_np(jp), "sdf", "sdf")
    x = np.random.default_rng(0).normal(0, 0.5, (200, 3)).astype(np.float32)
    js, jf = JSDF.sdf_apply(jp, jnet, jnp.asarray(x), ratio)
    ts, tf = net(torch.tensor(x), ratio)
    close(js, ts.detach(), atol=1e-5)
    close(jf, tf.detach(), atol=1e-5)
    jg = JSDF.sdf_grad(jp, jnet, jnp.asarray(x), ratio)
    tg = sdf_grad(net, torch.tensor(x), ratio)
    close(jg, tg.detach(), rtol=1e-4, atol=1e-5)


def test_sdf_full_width_config():
    jnet = JSDF.SDFNet()                # 8x512, skip 4, PE 6 (config.conf)
    jp = JSDF.init_sdf_params(jax.random.PRNGKey(3), jnet)
    net = load(SDFNet(seed=None), to_np(jp), "sdf", "sdf")
    x = np.random.default_rng(1).normal(0, 0.4, (256, 3)).astype(np.float32)
    js, jf = JSDF.sdf_apply(jp, jnet, jnp.asarray(x), 1.0)
    ts, tf = net(torch.tensor(x), 1.0)
    close(js, ts.detach(), atol=1e-5)
    close(jf, tf.detach(), atol=1e-5)
    close(JSDF.sdf_grad(jp, jnet, jnp.asarray(x), 1.0),
          sdf_grad(net, torch.tensor(x), 1.0).detach(), rtol=1e-4, atol=1e-5)


def test_port_init_draws_the_jax_weights():
    """The port's geometric init consumes the same numpy stream as
    init_sdf_params, so one seed gives identical weights."""
    key = jax.random.PRNGKey(6)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    jnet = JSDF.SDFNet(hidden=(64,) * 3, skip_in=(2,))
    ref = params_from_jax({"sdf": to_np(JSDF.init_sdf_params(key, jnet)),
                           "trans": [], "render": []})
    mine = SDFNet(hidden=(64,) * 3, skip_in=(2,), seed=seed).state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(mine[k[4:]].numpy(), v, rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("ratio", [None, 0.7])
def test_translator(ratio):
    jnet = JT.TranslatorNet(cond_size=8, multires=4, hidden=(64, 64, 64))
    jp = JT.init_translator_params(jax.random.PRNGKey(2), jnet)
    net = load(TranslatorNet(cond_size=8, multires=4, hidden=(64, 64, 64),
                             seed=None), to_np(jp), "trans", "deformer.defs.0")
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.5, (100, 3)).astype(np.float32)
    c = rng.normal(0, 0.1, (100, 8)).astype(np.float32)
    jo, joff = JT.translator_apply(jp, jnet, jnp.asarray(x), jnp.asarray(c),
                                   ratio)
    to, toff = net(torch.tensor(x), torch.tensor(c), ratio)
    close(jo, to.detach())
    close(joff, toff.detach(), atol=1e-7)


@pytest.mark.parametrize("ratio", [0.5, 0.73, 1.4])
def test_positional_encoding_takes_band_weights(ratio):
    """The band weights as a tensor (a CUDA graph's input) give the float
    ratio's encoding, annealed (0.5, 0.73) or saturated (1.4)."""
    w = annealing_band_weights(6, ratio)
    assert bool((w < 1.0).any()) == (ratio < 1.0)
    x = torch.tensor(np.random.default_rng(5).normal(0, 0.5, (64, 3)).astype(
        np.float32))
    assert torch.equal(positional_encoding(x, 6, w),
                       positional_encoding(x, 6, ratio))


def test_render_net():
    jnet = JR.RenderNet(feature_size=16, hidden=(64, 64), multires_v=4)
    jp = JR.init_render_params(jax.random.PRNGKey(4), jnet)
    net = load(RenderNet(feature_size=16, hidden=(64, 64), multires_v=4,
                         seed=None), to_np(jp), "render", "netRender")
    rng = np.random.default_rng(3)
    p, n, v = (rng.normal(size=(50, 3)).astype(np.float32) for _ in range(3))
    f = rng.normal(size=(50, 16)).astype(np.float32)
    jc = JR.render_apply(jp, jnet, *(jnp.asarray(a) for a in (p, n, v, f)),
                         0.6)
    tc = net(*(torch.tensor(a) for a in (p, n, v, f)), 0.6)
    close(jc, tc.detach())
