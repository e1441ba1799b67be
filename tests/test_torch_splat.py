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

The plain versions follow the kernels' structure: the sorted entry list
cut into ``SK.CHUNK``-entry chunks (the "chunks" cloud has a cell of more
than two chunks and runs that cross chunk edges), the mask formed inside
the forward, the cotangent -g * (1 - mask) inside the backward, and each
entry's gradient written at its entry id.
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
from selfreconcode_tpu_torch.utils import trace
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


def chunk_cloud(rng):
    # one 8x8 cell with ~150 entries (more than two chunks of SK.CHUNK) and
    # sparse neighbours of 5-30 entries, so that runs cross chunk edges
    n_big, n_small = 150, 120
    big = 8 + 2.5 + 3 * rng.random((n_big, 2))
    small = rng.uniform(2, 30, (n_small, 2))
    c = np.concatenate([big, small])
    return unproject(c[:, 0], c[:, 1], np.full(len(c), 2.5)), \
        np.ones(len(c), bool), 2.0


CASES = {"dense": dense_cloud, "border": border_cloud,
         "offscreen": offscreen_cloud, "chunks": chunk_cloud}


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
    mask = splat_mask(cam, tp, torch.tensor(valid), radius)
    (mask * torch.tensor(target)).sum().backward()
    _, _, b = _bins_for(pts, r_pix, "cpu", valid)
    occupancy = int(b.counts.max())
    if case == "dense":
        assert occupancy >= 300
    if case == "chunks":
        assert occupancy > 2 * SK.CHUNK
        ends = b.starts + b.counts - 1
        assert ((b.starts // SK.CHUNK != ends // SK.CHUNK)
                & (b.starts % SK.CHUNK != 0)).any()

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


def launches():
    """The kernel launches counted since the last read (which clears)."""
    return {k: v for k, v in trace.read_and_clear()["counters"].items()
            if k.endswith("_launches")}


def _bins_for(pts, r_pix, device, valid=None):
    cam = Camera(*(torch.tensor(a, device=device) for a in
                   (FOCAL, PRINC, R, T)), H, W)
    s = transform_points_screen(cam, torch.tensor(pts, device=device))
    col, row = s[:, 0].contiguous(), s[:, 1].contiguous()
    ok = torch.ones(len(pts), dtype=torch.bool, device=device) \
        if valid is None else torch.tensor(valid, device=device)
    return col, row, splat_bins(col, row, s[:, 2], ok, r_pix, H, W, 8)


def _fwd_args(col, row, b, r_pix):
    return (col, row, b.entries, b.ecell, b.cell_ids, b.starts, b.counts, 8,
            b.ncx, H, W, 1.0 / (r_pix * r_pix))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    pts, _, r_pix = dense_cloud(np.random.default_rng(3))
    col, row, b = _bins_for(pts, r_pix, "cpu")
    args = _fwd_args(col, row, b, r_pix)
    trace.read_and_clear()
    mask = SK.splat_fwd(*args)
    torch.testing.assert_close(mask, SK.splat_fwd_plain(*args))
    assert torch.equal(SK.fwd(*args), mask)
    g_img = torch.randn(H, W)
    bargs = (col, row, b.entries, b.ecell, g_img, mask, 8, b.ncx, args[-1],
             4 * col.shape[0])
    g = SK.splat_bwd(*bargs)
    assert g.shape == (4 * col.shape[0], 2)
    assert torch.equal(SK.bwd(*bargs), g)
    pts_d = torch.tensor(dense_slots(np.random.default_rng(3))[0])
    SK.splat_bwd_cells(pts_d, SK.splat_fwd_cells(pts_d, 8, 8, 2.5), 8, 8,
                       2.5)
    assert launches() == {}
    with pytest.raises(TypeError):
        SK.splat_fwd(col.double(), row, *args[2:])


def test_decode_takes_both_entry_layouts():
    """Entry ids k * n + p of the binning and the dense slot ids (k = 0)
    decode to their point without a modulo."""
    pts, _, r_pix = border_cloud(np.random.default_rng(6))
    col, _, b = _bins_for(pts, r_pix, "cpu")
    n = col.shape[0]
    assert int(b.entries.max()) >= 3 * n        # all four corners occur
    assert torch.equal(SK.decode(b.entries, n), b.entries.long() % n)
    slots = torch.arange(5 * 64, dtype=torch.int32)
    assert torch.equal(SK.decode(slots, 5 * 64), slots.long())
    bins, _, _ = SK.dense_bins(torch.tensor(dense_slots(
        np.random.default_rng(7))[0]), 8, 8)
    assert torch.equal(SK.decode(bins[2], bins[0].shape[0]),
                       bins[2].long())
    assert torch.equal(bins[3].long(), bins[2].long() // 64)


def test_plain_forward_sums_chunks_and_fuses_the_mask():
    """The chunked sum equals a direct per-pixel sum to float rounding; the
    mask epilogue is exactly 1 - exp of the accumulator."""
    pts, valid, r_pix = chunk_cloud(np.random.default_rng(8))
    col, row, b = _bins_for(pts, r_pix, "cpu", valid)
    args = _fwd_args(col, row, b, r_pix)
    acc = SK.splat_fwd_plain(*args, to_mask=False)
    mask = SK.splat_fwd_plain(*args)
    assert torch.equal(mask, 1.0 - torch.exp(acc))
    r2_inv = args[-1]
    p = b.entries.long() % col.shape[0]
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    ref = torch.zeros(H, W, dtype=torch.float64)
    for cell, i in zip(b.ecell.tolist(), p.tolist()):
        cy, cx = divmod(cell, b.ncx)
        inside = (yy // 8 == cy) & (xx // 8 == cx)
        w = 1.0 - ((col[i] - xx) ** 2 + (row[i] - yy) ** 2) * r2_inv
        ref += torch.where(inside, torch.log1p(-w.clamp(0.0, SK.W_MAX)),
                           torch.zeros_like(w)).double()
    np.testing.assert_allclose(acc.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_plain_backward_fuses_the_cotangent_into_entry_slots():
    """-g * (1 - mask) formed inside equals the cotangent given outright;
    each entry's pair lands at its entry id and every other slot is 0."""
    pts, valid, r_pix = chunk_cloud(np.random.default_rng(9))
    col, row, b = _bins_for(pts, r_pix, "cpu", valid)
    args = _fwd_args(col, row, b, r_pix)
    mask = SK.splat_fwd_plain(*args)
    g_img = torch.randn(H, W, generator=torch.Generator().manual_seed(0))
    n = col.shape[0]
    g = SK.splat_bwd_plain(col, row, b.entries, b.ecell, g_img, mask, 8,
                           b.ncx, args[-1], 4 * n)
    g_cot = SK.splat_bwd_plain(col, row, b.entries, b.ecell,
                               -g_img * (1.0 - mask), None, 8, b.ncx,
                               args[-1], 4 * n)
    assert torch.equal(g, g_cot)
    unused = torch.ones(4 * n, dtype=torch.bool)
    unused[b.entries.long()] = False
    assert (g[unused] == 0).all() and g[~unused].abs().max() > 0


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
    pts, valid, r_pix = chunk_cloud(np.random.default_rng(4))
    col, row, b = _bins_for(pts, r_pix, "cuda", valid)
    args = _fwd_args(col, row, b, r_pix)
    trace.read_and_clear()
    mask = SK.splat_fwd(*args)
    assert launches() == {"splat_fwd_launches": 1}
    torch.testing.assert_close(mask, SK.splat_fwd_plain(*args), rtol=0,
                               atol=1e-6)
    assert torch.equal(mask, SK.splat_fwd(*args))          # bit-deterministic
    acc = SK.splat_fwd(*args, to_mask=False)
    torch.testing.assert_close(acc, SK.splat_fwd_plain(*args, to_mask=False),
                               rtol=1e-4, atol=1e-4)
    g_img = torch.randn(H, W, device="cuda")
    bwd = (col, row, b.entries, b.ecell, g_img, mask, 8, b.ncx, args[-1],
           4 * col.shape[0])
    g = SK.splat_bwd(*bwd)
    gp = SK.splat_bwd_plain(*bwd)
    torch.testing.assert_close(g, gp, rtol=0,
                               atol=1e-4 * float(gp.abs().max()))
    assert torch.equal(g, SK.splat_bwd(*bwd))
    # the unchecked launchers count where they launch, whoever calls them
    trace.read_and_clear()
    SK.fwd(*args)
    SK.bwd(*bwd)
    assert launches() == {"splat_fwd_launches": 1, "splat_bwd_launches": 1}
    pts_d, _ = dense_slots(np.random.default_rng(5))
    pts_d = torch.tensor(pts_d, device="cuda")
    torch.testing.assert_close(SK.splat_fwd_cells(pts_d, 8, 8, 2.5),
                               SK.splat_fwd_cells_plain(pts_d, 8, 8, 2.5),
                               rtol=1e-4, atol=1e-4)
    cot_d = torch.randn(32, 64, device="cuda")
    gd = SK.splat_bwd_cells_plain(pts_d, cot_d, 8, 8, 2.5)
    torch.testing.assert_close(SK.splat_bwd_cells(pts_d, cot_d, 8, 8, 2.5),
                               gd, rtol=0, atol=1e-4 * float(gd.abs().max()))
    assert launches() == {"splat_fwd_cells_launches": 1,
                          "splat_bwd_cells_launches": 1}
    # no entry: the wrappers launch nothing and count nothing
    none = torch.zeros(0, dtype=torch.int32, device="cuda")
    m0 = SK.splat_fwd(col, row, none, none, none, none, none, 8, b.ncx, H, W,
                      args[-1])
    g0 = SK.splat_bwd(col, row, none, none, g_img, m0, 8, b.ncx, args[-1],
                      4 * col.shape[0])
    assert (m0 == 0).all() and (g0 == 0).all()
    assert launches() == {}
