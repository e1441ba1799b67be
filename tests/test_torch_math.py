"""Parity of the port's leaf math with the JAX package on seeded inputs.

Tolerance 1e-5 relative: both sides evaluate the same closed forms in
float32; only the order of a few sums differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.utils import math as JM
from selfreconcode_tpu.utils import pe as JP
from selfreconcode_tpu.utils import sampling as JS
from selfreconcode_tpu_torch.utils import math as TM
from selfreconcode_tpu_torch.utils import pe as TP
from selfreconcode_tpu_torch.utils import sampling as TS

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_inv3x3_and_check_mask():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(64, 3, 3)).astype(np.float32)
    m[:8] = np.outer([1, 2, 3], [1, -1, 0.5]).astype(np.float32)  # rank 1
    m[8:12] *= 1e-2                                               # |det| ~1e-6
    ji, jok = JM.inv3x3(jnp.asarray(m))
    ti, tok = TM.inv3x3(torch.tensor(m))
    assert not bool(tok[:12].any())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    close(ji, ti, rtol=1e-4, atol=1e-5)


def test_eigvals_sym3_including_repeated_roots():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(32, 3, 3)).astype(np.float32)
    a = a @ np.swapaxes(a, 1, 2)
    iso = np.stack([np.eye(3, dtype=np.float32) * s for s in (0.5, 1.0, 2.0)])
    q, _ = np.linalg.qr(rng.normal(size=(4, 3, 3)))
    two = (q @ np.diag([1.0, 1.0, 3.0]) @ np.swapaxes(q, 1, 2)).astype(
        np.float32)
    mats = np.concatenate([a, iso, two])
    je = np.asarray(JM.eigvals_sym3(jnp.asarray(mats)))
    te = TM.eigvals_sym3(torch.tensor(mats)).numpy()
    close(je, te, rtol=1e-5, atol=1e-5)
    close(te[:32], np.linalg.eigvalsh(a.astype(np.float64)), rtol=1e-3,
          atol=1e-3)
    # the degenerate (isotropic) branch leaks no NaN into the gradient
    x = torch.tensor(iso, requires_grad=True)
    TM.eigvals_sym3(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_log_singular_values_sq_sum():
    rng = np.random.default_rng(2)
    j = (np.eye(3) + 0.2 * rng.normal(size=(128, 3, 3))).astype(np.float32)
    j[:4] = np.eye(3, dtype=np.float32)
    close(JM.log_singular_values_sq_sum(jnp.asarray(j)),
          TM.log_singular_values_sq_sum(torch.tensor(j)), atol=1e-6)


def test_rotations_gm_normalize_dct():
    rng = np.random.default_rng(3)
    th = rng.normal(size=(16, 3)).astype(np.float32)
    close(JM.batch_rodrigues(jnp.asarray(th)),
          TM.batch_rodrigues(torch.tensor(th)))
    x = rng.normal(size=100).astype(np.float32)
    for sq in (False, True):
        close(JM.gm_robust(jnp.asarray(x ** 2), 0.5, sq),
              TM.gm_robust(torch.tensor(x ** 2), 0.5, sq))
    v = rng.normal(size=(10, 3)).astype(np.float32)
    close(JM.normalize(jnp.asarray(v)), TM.normalize(torch.tensor(v)))
    np.testing.assert_array_equal(JM.dct_null_space(3, 11),
                                  TM.dct_null_space(3, 11))


@pytest.mark.parametrize("ratio", [None, -1.0, 0.0, 0.3, 0.55, 1.0])
def test_positional_encoding_annealed(ratio):
    x = np.random.default_rng(4).normal(size=(7, 3)).astype(np.float32)
    close(JP.positional_encoding(jnp.asarray(x), 6, ratio),
          TP.positional_encoding(torch.tensor(x), 6, ratio))


def test_sampling_with_fed_draws():
    import jax
    rng = np.random.default_rng(5)
    pc = rng.normal(size=(60, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    out = JS.sample_points(key, jnp.asarray(pc), 1.8, 0.01)
    k1, k2 = jax.random.split(key)
    n = np.asarray(jax.random.normal(k1, (60, 3)))
    u = np.asarray(jax.random.uniform(k2, (10, 3)))
    mine = TS.sample_points(torch.tensor(pc), 1.8, 0.01,
                            noise=(torch.tensor(n), torch.tensor(u)))
    close(out, mine)

    valid = rng.random(200) > 0.3
    idx, sel = JS.subsample_mask_topk(key, jnp.asarray(valid), 50)
    scores = np.asarray(jax.random.uniform(key, (200,)))
    tidx, tsel = TS.subsample_mask_topk(torch.tensor(valid), 50,
                                        scores=torch.tensor(scores))
    np.testing.assert_array_equal(np.asarray(idx), tidx.numpy())
    np.testing.assert_array_equal(np.asarray(sel), tsel.numpy())
