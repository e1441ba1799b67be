"""The port's PointRend-style uncertainty selection
(``selfreconcode_tpu_torch/ops/uncertainty.py``) and fused 2x upsample with
sign-boundary flags (``ops/sparse_sdf.py::interp2x_boundary3d``) against the
JAX package's, on seeded inputs, mirroring ``tests/test_uncertainty.py`` and
``tests/test_sparse_sdf.py::test_interp2x_boundary3d_forward_and_grad``.

Tolerances: the uncertainty is one subtraction and an abs, so it is held
bit for bit; the selections are top-k of continuous random scores (no ties)
and are held index for index, coordinates included; the clip-min padding
rows (scores -inf, where the two top-k orders may differ) only by count and
position.  The upsample is a mean of two float32 values per axis in the same
order in both, held bit for bit, and the boundary mask exactly; its
gradient (a sum of cotangent halves) to 1e-6 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.ops import sparse_sdf as JSS
from selfreconcode_tpu.ops import uncertainty as JU
from selfreconcode_tpu_torch.ops import sparse_sdf as TSS
from selfreconcode_tpu_torch.ops import uncertainty as TU


def test_calculate_uncertainty_matches_jax():
    rs = np.random.RandomState(0)
    agnostic = rs.randn(4, 1, 5, 5).astype(np.float32)
    specific = rs.randn(3, 4, 6).astype(np.float32)
    classes = np.array([2, 0, 3])
    for logits, cls in ((agnostic, None), (specific, classes)):
        j = JU.calculate_uncertainty(
            jnp.asarray(logits), None if cls is None else jnp.asarray(cls))
        t = TU.calculate_uncertainty(
            torch.tensor(logits), None if cls is None else torch.tensor(cls))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("shape,k", [((2, 1, 7, 9), 10),
                                     ((1, 1, 4, 5, 6), 8),
                                     ((3, 1, 3, 4, 2), 24)])
def test_uncertain_points_match_jax(shape, k):
    m = np.random.RandomState(len(shape) + k).rand(*shape).astype(np.float32)
    fn = "uncertain_points_grid2d" if len(shape) == 4 else \
        "uncertain_points_grid3d"
    j = [np.asarray(x) for x in getattr(JU, fn)(jnp.asarray(m), k)]
    t = [x.numpy() for x in getattr(TU, fn)(torch.tensor(m), k)]
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_clip_min_pads_like_jax():
    rs = np.random.RandomState(5)
    m = rs.rand(2, 1, 6, 7).astype(np.float32)
    j_idx, j_coords, j_valid = (np.asarray(x) for x in
                                JU.uncertain_points_grid2d(jnp.asarray(m), 12,
                                                           clip_min=0.8))
    t_idx, t_coords, t_valid = (x.numpy() for x in
                                TU.uncertain_points_grid2d(torch.tensor(m),
                                                           12, clip_min=0.8))
    np.testing.assert_array_equal(t_valid, j_valid)
    assert 0 < t_valid.sum() < t_valid.size     # some rows are padding
    np.testing.assert_array_equal(t_idx[t_valid], j_idx[j_valid])
    np.testing.assert_array_equal(t_coords[t_valid], j_coords[j_valid])


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_interp2x_boundary3d_matches_jax(dilate):
    rng = np.random.default_rng(11 + dilate)
    vol = rng.normal(0, 1, (5, 7, 3)).astype(np.float32)
    balance = 0.1
    j_up, j_bnd = jax.jit(lambda v: JSS.interp2x_boundary3d(
        v, balance, dilate))(jnp.asarray(vol))
    tv = torch.tensor(vol, requires_grad=True)
    t_up, t_bnd = TSS.interp2x_boundary3d(tv, balance, dilate)
    assert t_up.shape == (9, 13, 5)
    np.testing.assert_array_equal(t_up.detach().numpy(), np.asarray(j_up))
    np.testing.assert_array_equal(t_bnd.numpy(), np.asarray(j_bnd))

    w = rng.normal(0, 1, t_up.shape).astype(np.float32)
    (t_up * torch.tensor(w)).sum().backward()
    j_g = jax.grad(lambda v: (JSS.interp2x_boundary3d(v, balance, dilate)[0]
                              * jnp.asarray(w)).sum())(jnp.asarray(vol))
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(j_g), atol=1e-6)
