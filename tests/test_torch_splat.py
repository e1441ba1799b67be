"""Parity of the port's splat soft mask with the JAX ``splat_mask``, and of
the dense-cell kernel forms with the JAX ``splat_fwd_cells`` /
``splat_bwd_cells``.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions (the wrapper's CPU dispatch).  JAX is given
a cell_cap at least the measured max occupancy, and the test asserts its
``stats[0] == 0`` (nothing dropped): only there do the two agree, because
the port has no capacity.  Tolerances: mask atol 1e-6; gradients of
(mask * target).sum() w.r.t. points and camera at 1e-4 * max|g|, since the
per-pixel and per-point sums run in another order.  Dense forms: the
accumulator at 1e-5 relative (+1e-5 absolute), the per-slot gradient at
1e-5 * max|g|, empty slots exactly zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.ops import pallas_raster as PR
from selfreconcode_tpu.ops.rasterize import splat_mask as jsplat
from selfreconcode_tpu.render.camera import Camera as JCam
from selfreconcode_tpu_torch.ops import splat_kernels as SK
from selfreconcode_tpu_torch.ops.rasterize import splat_bins, splat_mask
from selfreconcode_tpu_torch.render.camera import (Camera,
                                                   transform_points_screen)

H = W = 32
FOCAL = np.array([30.0, 31.0], np.float32)
PRINC = np.array([15.5, 16.2], np.float32)
R = np.eye(3, dtype=np.float32)
T = np.array([0.0, 0.0, 2.5], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unproject(col, row, z):
    """World points that land near screen (col, row) at depth z."""
    x = (PRINC[0] - col) * z / FOCAL[0]
    y = (PRINC[1] - row) * z / FOCAL[1]
    return np.stack([x, y, z - T[2]], 1).astype(np.float32)


def dense_cloud(rng):
    # ~1200 splats over a 16x16 px block: ~300+ entries per 8x8 cell
    n = 1200
    return unproject(8 + 16 * rng.random(n), 8 + 16 * rng.random(n),
                     2.5 + 0.1 * rng.random(n)), np.ones(n, bool), 2.5


def border_cloud(rng):
    # centres within half a radius of the 8 px cell borders
    n = 400
    b = rng.choice([8.0, 16.0, 24.0], size=(n, 2))
    c = b + rng.uniform(-1.5, 1.5, (n, 2))
    return unproject(c[:, 0], c[:, 1], np.full(n, 2.5)), \
        rng.random(n) > 0.1, 3.0


def offscreen_cloud(rng):
    # on, partly off and fully off screen, plus points behind the camera
    n = 500
    c = rng.uniform(-6, 38, (n, 2))
    z = np.where(rng.random(n) < 0.2, -1.0, 2.5 + rng.random(n))
    return unproject(c[:, 0], c[:, 1], z), np.ones(n, bool), 2.0


CASES = {"dense": dense_cloud, "border": border_cloud,
         "offscreen": offscreen_cloud}


@pytest.mark.parametrize("case", sorted(CASES))
def test_splat_mask_and_grads_match_jax(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    pts, valid, r_pix = CASES[case](rng)
    radius = 2.0 * r_pix / W
    target = rng.random((H, W)).astype(np.float32)

    tp = torch.tensor(pts, requires_grad=True)
    cam_leaves = [torch.tensor(a, requires_grad=True) for a in (FOCAL, PRINC, T)]
    cam = Camera(cam_leaves[0], cam_leaves[1], torch.tensor(R), cam_leaves[2],
                 H, W)
    mask, stats = splat_mask(cam, tp, torch.tensor(valid), radius,
                             return_stats=True)
    (mask * torch.tensor(target)).sum().backward()
    occupancy = int(stats[0])
    if case == "dense":
        assert occupancy >= 300

    def jloss(p, f, pr, t):
        jc = JCam(f, pr, jnp.asarray(R), t, H, W)
        m, st = jsplat(jc, p, jnp.asarray(valid), radius,
                       cell_cap=occupancy + 64, active_cells=256,
                       return_overflow=True)
        return (m * target).sum(), (m, st)

    (_, (jm, st)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(pts), jnp.asarray(FOCAL), jnp.asarray(PRINC),
        jnp.asarray(T))
    assert int(st[0]) == 0, "JAX dropped candidates: not comparable"
    assert int(st[1]) == occupancy
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(jm),
                               atol=1e-6)
    for mine, ref in zip([tp] + cam_leaves, jg):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def _bins_for(pts, r_pix, device):
    cam = Camera(*(torch.tensor(a, device=device) for a in
                   (FOCAL, PRINC, R, T)), H, W)
    s = transform_points_screen(cam, torch.tensor(pts, device=device))
    col, row = s[:, 0].contiguous(), s[:, 1].contiguous()
    ok = torch.ones(len(pts), dtype=torch.bool, device=device)
    return col, row, splat_bins(col, row, s[:, 2], ok, r_pix, H, W, 8)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    pts, _, r_pix = dense_cloud(np.random.default_rng(3))
    col, row, b = _bins_for(pts, r_pix, "cpu")
    args = (col, row, b.entries, b.cell_ids, b.starts, b.counts)
    r2_inv = 1.0 / (r_pix * r_pix)
    before = (SK.launches.splat_fwd_launches, SK.launches.splat_bwd_launches)
    acc = SK.splat_fwd(*args, 8, b.ncx, b.hp, b.wp, r2_inv)
    torch.testing.assert_close(
        acc, SK.splat_fwd_plain(*args, 8, b.ncx, b.hp, b.wp, r2_inv))
    cot = torch.randn(b.hp, b.wp)
    g = SK.splat_bwd(*args, cot, 8, b.ncx, r2_inv)
    assert g.shape == (b.entries.numel(), 2)
    assert (SK.launches.splat_fwd_launches,
            SK.launches.splat_bwd_launches) == before
    with pytest.raises(TypeError):
        SK.splat_fwd(col.double(), row, *args[2:], 8, b.ncx, b.hp, b.wp,
                     r2_inv)


def dense_slots(rng, C=32, ncx=8, cs=8, cap=64, r_pix=2.5):
    """(C, 2, cap) slots around each cell (some reach into the neighbours),
    ~30% empty (col = BIG), and cell 5 empty altogether."""
    c = np.arange(C)
    x0 = (c % ncx * cs)[:, None]
    y0 = (c // ncx * cs)[:, None]
    col = x0 + rng.uniform(-r_pix, cs + r_pix, (C, cap))
    row = y0 + rng.uniform(-r_pix, cs + r_pix, (C, cap))
    empty = rng.random((C, cap)) < 0.3
    empty[5] = True
    col = np.where(empty, PR.BIG, col)
    return np.stack([col, row], 1).astype(np.float32), ~empty


@pytest.mark.parametrize("C,ncx", [(16, 4), (32, 8)])
def test_dense_cell_forms_match_jax(C, ncx):
    rng = np.random.default_rng(C)
    cs, r_pix = 8, 2.5
    pts, valid = dense_slots(rng, C, ncx, cs, 64, r_pix)
    acc_j = np.asarray(PR.splat_fwd_cells(jnp.asarray(pts), cs, ncx, r_pix))
    acc = SK.splat_fwd_cells(torch.tensor(pts), cs, ncx, r_pix)
    assert acc.shape == (C, cs * cs)
    np.testing.assert_allclose(acc.numpy(), acc_j, rtol=1e-5, atol=1e-5)
    assert (acc_j[5] == 0).all() and (acc.numpy()[5] == 0).all()
    cot = rng.standard_normal((C, cs * cs)).astype(np.float32)
    g_j = np.asarray(PR.splat_bwd_cells(jnp.asarray(pts), jnp.asarray(cot),
                                        cs, ncx, r_pix))
    g = SK.splat_bwd_cells(torch.tensor(pts), torch.tensor(cot), cs, ncx,
                           r_pix).numpy()
    assert g.shape == (C, 2, 64)
    np.testing.assert_allclose(g, g_j, rtol=0, atol=1e-5 * np.abs(g_j).max())
    assert (g.transpose(0, 2, 1)[~valid] == 0).all()
    assert np.abs(g).max() > 0


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs in chip_smoke.py on the card)")
    pts, _, r_pix = dense_cloud(np.random.default_rng(4))
    col, row, b = _bins_for(pts, r_pix, "cuda")
    args = (col, row, b.entries, b.cell_ids, b.starts, b.counts)
    r2_inv = 1.0 / (r_pix * r_pix)
    n0 = SK.launches.splat_fwd_launches
    acc = SK.splat_fwd(*args, 8, b.ncx, b.hp, b.wp, r2_inv)
    assert SK.launches.splat_fwd_launches == n0 + 1
    ref = SK.splat_fwd_plain(*args, 8, b.ncx, b.hp, b.wp, r2_inv)
    torch.testing.assert_close(acc, ref, rtol=1e-4, atol=1e-4)
    cot = torch.randn(b.hp, b.wp, device="cuda")
    g = SK.splat_bwd(*args, cot, 8, b.ncx, r2_inv)
    gp = SK.splat_bwd_plain(*args, cot, 8, b.ncx, r2_inv)
    torch.testing.assert_close(g, gp, rtol=0,
                               atol=1e-4 * float(gp.abs().max()))
    pts_d, _ = dense_slots(np.random.default_rng(5))
    pts_d = torch.tensor(pts_d, device="cuda")
    torch.testing.assert_close(SK.splat_fwd_cells(pts_d, 8, 8, 2.5),
                               SK.splat_fwd_cells_plain(pts_d, 8, 8, 2.5),
                               rtol=1e-4, atol=1e-4)
    cot_d = torch.randn(32, 64, device="cuda")
    gd = SK.splat_bwd_cells_plain(pts_d, cot_d, 8, 8, 2.5)
    torch.testing.assert_close(SK.splat_bwd_cells(pts_d, cot_d, 8, 8, 2.5),
                               gd, rtol=0, atol=1e-4 * float(gd.abs().max()))
    # no active cell: the wrappers launch nothing and count nothing
    none = torch.zeros(0, dtype=torch.int32, device="cuda")
    n0 = (SK.launches.splat_fwd_launches, SK.launches.splat_bwd_launches)
    acc0 = SK.splat_fwd(col, row, none, none, none, none, 8, b.ncx, b.hp,
                        b.wp, r2_inv)
    g0 = SK.splat_bwd(col, row, none, none, none, none, cot, 8, b.ncx, r2_inv)
    assert (acc0 == 0).all() and g0.shape == (0, 2)
    assert (SK.launches.splat_fwd_launches,
            SK.launches.splat_bwd_launches) == n0
