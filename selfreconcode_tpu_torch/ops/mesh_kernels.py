"""Mesh-fragment kernel: build, launch wrapper, plain version, counter.

The kernel in ``csrc/mesh_raster.cu`` replaces the Pallas kernel
``mesh_fragments_cells`` (``selfreconcode_tpu/ops/pallas_raster.py:116``).
It is compiled with ``nvcc`` for ``sm_90a`` (with ``-fmad=false``, so it
rounds like the plain version) into
``build/kernels/<content-hash>/libsrt_mesh_raster.so`` at first use and
called through ``ctypes``.

It walks the binned entry list that ``ops/rasterize.py::cell_bins`` builds
(entry mod n_faces = face id; runs grouped by cell in ascending cell order)
and one (F, 9) float32 record per face: p0x p0y p1x p1y p2x p2y z0 z1 z2
(screen col, row and camera depth of its three vertices).

The kernel's rules beyond the plain version's arithmetic are here as small
functions that ``mesh_raster.cu`` mirrors line by line, so the CPU tests
can hold them: ``pixel_box`` (the only pixels an entry tests),
``inside_by_signs`` (the inside test without divides) and ``pack_key`` /
``unpack_key`` (the per-pixel (depth, run position) key whose minimum picks
the winner).

Dispatch rule: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
goes to the kernel or raises.  Each kernel launch (and nothing else) adds
one to the host counter ``mesh_raster_launches`` of ``utils/trace.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from ._cuda_build import CudaLibrary, check_launch

_MAX_PAIRS = 1 << 22   # (entry, pixel) pairs per chunk of the plain version
MAX_SIDE = 8192        # image side up to which BOX_SLACK covers the box's
                       # own rounding (half an ulp below 8192 is 2^-11 px)
BOX_SLACK = 1e-3       # px added to every box margin
_U = 2.0 ** -24        # float32 unit roundoff
_TINY = 1e-37          # covers the edge functions' underflow (2^-148 |area|)
KEY_EMPTY = (1 << 63) - 1   # a pixel no entry reached; above every key


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.srt_mesh_raster.argtypes = [p, i, p, i, p, p, p, i, i, i, i, i, p, p,
                                    p, p]
    lib.srt_mesh_raster.restype = ctypes.c_int


LIB = CudaLibrary("mesh_raster.cu", "libsrt_mesh_raster", _bind,
                  extra_flags=("-fmad=false",))


def _check_inputs(rec, entries, cell_ids, starts, counts, cs):
    if rec.dtype != torch.float32 or rec.dim() != 2 or rec.shape[1] != 9 \
            or not rec.is_contiguous():
        raise ValueError(f"rec must be a contiguous float32 (F, 9) tensor, "
                         f"got {rec.dtype} {tuple(rec.shape)}")
    for name, t in (("entries", entries), ("cell_ids", cell_ids),
                    ("starts", starts), ("counts", counts)):
        if t.device != rec.device:
            raise ValueError(f"{name} is on {t.device}, rec on {rec.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if not (cell_ids.shape == starts.shape == counts.shape):
        raise ValueError("cell_ids, starts and counts must have one length")
    if not 1 <= cs <= 32:
        raise ValueError(f"cell size {cs} outside [1, 32] (cs*cs keys in "
                         f"shared memory)")


def _fill(H: int, W: int, device):
    return (torch.full((H, W), float("inf"), device=device),
            torch.full((H, W), -1, dtype=torch.int32, device=device),
            torch.zeros((H, W, 3), device=device))


def edge_bary(r, X, Y):
    """Normalized edge functions of records r (..., 9) at pixels (X, Y);
    the same expression order as the kernel's ``edge_bary``."""
    ax, ay, bx, by, cx, cy = (r[..., j] for j in range(6))
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    w0 = (cx - bx) * (Y - by) - (cy - by) * (X - bx)
    w1 = (ax - cx) * (Y - cy) - (ay - cy) * (X - cx)
    w2 = (bx - ax) * (Y - ay) - (by - ay) * (X - ax)
    ok_area = area.abs() > 1e-12
    denom = torch.where(ok_area, area, torch.ones_like(area))
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & ok_area
    return b0, b1, b2, inside


def pixel_box(r):
    """(x_lo, x_hi, y_lo, y_hi): the integer pixel range, inclusive, as
    float32, outside which ``edge_bary`` puts no pixel of the records r
    (..., 9) inside.  The kernel's ``pixel_box`` mirrors it line by line.

    The box is the screen bbox widened by a margin R.  ``edge_bary``'s w_i
    has the sign of the exact edge function of the float inputs up to
    4u (|Ex| |Dy| + |Ey| |Dx|) (u = 2^-24; the differences and the products
    round, the last difference keeps the sign), so an inside pixel P has
    exact barycentrics lambda_i >= -(4u e (ext + d) + tiny) / a_lo, with e
    the largest edge 1-norm, ext the bbox's longer side, d the distance
    (max-norm) from P to the bbox, and a_lo <= |exact area| (the rounded
    area less 8u (|t1| + |t2|)).  At most two lambda are negative and
    P = sum lambda_i V_i, so d <= ext * (sum of the negative lambda), which
    gives d <= 2 ext (q + nu) / (1 - 2q), q = 4u e ext / a_lo.  For
    q <= 1/8 the box takes R = 4 ext (q + nu) + BOX_SLACK (1.5x over the
    bound, which covers R's own rounding; BOX_SLACK covers the rounding of
    x0 - R below MAX_SIDE px).  A typical face gets R ~ BOX_SLACK; a
    sliver whose rounded area is not above its rounding error (a_lo <= 0)
    or with q > 1/8 gets R = inf, so the kernel walks its whole cell: the
    float32 inside test of such a sliver does reach pixels well outside
    its bbox (tests/test_torch_raster_mesh.py holds one).  A face that
    ``edge_bary`` refuses outright (|area| <= 1e-12) gets an empty box."""
    ax, ay, bx, by, cx, cy = (r[..., j] for j in range(6))
    x0 = torch.fmin(torch.fmin(ax, bx), cx)
    x1 = torch.fmax(torch.fmax(ax, bx), cx)
    y0 = torch.fmin(torch.fmin(ay, by), cy)
    y1 = torch.fmax(torch.fmax(ay, by), cy)
    ext = torch.fmax(x1 - x0, y1 - y0)
    e = torch.fmax(torch.fmax((cx - bx).abs() + (cy - by).abs(),
                              (ax - cx).abs() + (ay - cy).abs()),
                   (bx - ax).abs() + (by - ay).abs())
    t1 = (bx - ax) * (cy - ay)
    t2 = (by - ay) * (cx - ax)
    area = t1 - t2
    a_lo = area.abs() - 8.0 * _U * (t1.abs() + t2.abs())
    q = 4.0 * _U * e * ext / a_lo
    nu = _TINY * (1.0 + area.abs()) / a_lo
    inf = torch.full_like(ext, float("inf"))
    R = torch.where((a_lo > 0) & (q <= 0.125),
                    4.0 * ext * (q + nu) + BOX_SLACK, inf)
    R = torch.where(area.abs() > 1e-12, R, -inf)
    return (torch.ceil(x0 - R), torch.floor(x1 + R), torch.ceil(y0 - R),
            torch.floor(y1 + R))


def inside_by_signs(area, w0, w1, w2):
    """``edge_bary``'s inside test from the edge functions without its
    divides, exactly (the kernel's ``staged_inside``).  w / area < 0 in
    float32 when the signs differ and |w / area| > 2^-150; at or below it
    the quotient rounds to -0, which passes b >= 0.  For 1e-12 < |area| <
    inf, w k (k = sign(area) 2^100) and -|area| 2^-50 are exact scalings,
    so b >= 0 is w k >= -|area| 2^-50, which a NaN w fails as its NaN b
    fails b >= 0.  Any other area divides as ``edge_bary`` does."""
    a = area.abs()
    nan = torch.full_like(area, float("nan"))
    k = torch.where((a > 1e-12) & (a < float("inf")),
                    torch.copysign(torch.full_like(area, 2.0 ** 100), area),
                    nan)
    lim = -(a * 2.0 ** -50)
    fast = (w0 * k >= lim) & (w1 * k >= lim) & (w2 * k >= lim)
    ok = a > 1e-12
    d = torch.where(ok, area, torch.ones_like(area))
    slow = ok & (w0 / d >= 0) & (w1 / d >= 0) & (w2 / d >= 0)
    return torch.where(torch.isnan(k), slow, fast)


def pack_key(z, pos):
    """The kernel's per-pixel key (int64): z's float32 bits above the
    entry's sorted run position.  z is positive and finite (1 / max(inv_z,
    1e-12)), so its bits order as the floats do, and the least key is the
    least z, then the first in run order: the plain version's tie rule.
    Every key is below ``KEY_EMPTY``."""
    bits = z.contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | pos.to(torch.int64)


def unpack_key(key):
    """(z float32, run position int64) of keys from ``pack_key``."""
    z = (key >> 32).to(torch.int32).view(torch.float32)
    return z, key & 0xFFFFFFFF


def mesh_fragments_plain(rec, entries, cell_ids, starts, counts, cs: int,
                         ncx: int, H: int, W: int):
    """(zbuf (H, W), face (H, W) int32, bary (H, W, 3)) over (entry, pixel)
    pairs: an amin scatter of z per pixel, then an amin scatter of the
    sorted position among the pairs that reach it (the kernel's first-entry
    tie rule), then the winner's barycentrics.  Works through the active
    cells in chunks of at most ~_MAX_PAIRS pairs."""
    dev = rec.device
    F, P, M = rec.shape[0], cs * cs, entries.shape[0]
    zbuf, face, bary = _fill(H, W, dev)
    z_flat = zbuf.reshape(-1)
    win = torch.full((H * W,), M, dtype=torch.long, device=dev)
    k = torch.arange(P, device=dev)
    ends = torch.cumsum(counts.long(), 0).cpu()
    a0 = 0
    while a0 < cell_ids.shape[0]:
        e0 = int(ends[a0 - 1]) if a0 else 0
        a1 = int(torch.searchsorted(ends, e0 + max(_MAX_PAIRS // P, 1),
                                    right=True))
        a1 = max(a1, a0 + 1)
        e1 = int(ends[a1 - 1])
        pos = torch.arange(e0, e1, device=dev)
        cell = torch.repeat_interleave(cell_ids[a0:a1].long(),
                                       counts[a0:a1].long())
        px = (cell % ncx * cs)[:, None] + k % cs                 # (m, P)
        py = (cell // ncx * cs)[:, None] + k // cs
        r = rec[entries[e0:e1].long() % F][:, None, :]           # (m, 1, 9)
        b0, b1, b2, inside = edge_bary(r, px.float(), py.float())
        inv_z = b0 / r[..., 6] + b1 / r[..., 7] + b2 / r[..., 8]
        z = 1.0 / inv_z.clamp_min(1e-12)
        inside = inside & (px < W) & (py < H)
        pix = (py * W + px)[inside]
        z = z[inside]
        z_flat.scatter_reduce_(0, pix, z, "amin")
        tie = z == z_flat[pix]
        win.scatter_reduce_(0, pix[tie],
                            pos[:, None].expand(-1, P)[inside][tie], "amin")
        a0 = a1
    hit = torch.nonzero(win < M).squeeze(1)
    f = entries[win[hit]].long() % F
    r = rec[f]
    X, Y = (hit % W).float(), (hit // W).float()
    b0, b1, b2, _ = edge_bary(r, X, Y)
    t = torch.stack([b0 / r[:, 6], b1 / r[:, 7], b2 / r[:, 8]], dim=1)
    ts = (t[:, 0] + t[:, 1] + t[:, 2]).clamp_min(1e-12)
    face.reshape(-1)[hit] = f.to(torch.int32)
    bary.reshape(-1, 3)[hit] = t / ts[:, None]
    return zbuf, face, bary


def raster_call(rec, entries, cell_ids, starts, counts, cs: int, ncx: int,
                H: int, W: int):
    """One launch as (ctypes function, its arguments, the filled outputs
    (zbuf, face, bary) and the cells in launch order): the kernel alone,
    with the arguments prepared once.  The cells go to the kernel fullest
    first, so the longest blocks start first."""
    zbuf, face, bary = _fill(H, W, rec.device)
    order = torch.argsort(counts, descending=True)
    cells = tuple(t[order].contiguous() for t in (cell_ids, starts, counts))
    return LIB.load().srt_mesh_raster, (
        rec.data_ptr(), rec.shape[0], entries.data_ptr(), entries.shape[0],
        *(t.data_ptr() for t in cells), cell_ids.shape[0], cs, ncx, H, W,
        zbuf.data_ptr(), face.data_ptr(), bary.data_ptr(),
        torch.cuda.current_stream(rec.device).cuda_stream), (zbuf, face, bary,
                                                             cells)


def mesh_fragments(rec, entries, cell_ids, starts, counts, cs: int, ncx: int,
                   H: int, W: int):
    """(zbuf, face, bary) images.  CPU -> plain version; CUDA -> the kernel
    (or an exception)."""
    _check_inputs(rec, entries, cell_ids, starts, counts, cs)
    if max(H, W) > MAX_SIDE:
        raise ValueError(f"image {H}x{W} above {MAX_SIDE} px a side (the "
                         f"kernel's pixel box slack)")
    if rec.device.type == "cpu":
        return mesh_fragments_plain(rec, entries, cell_ids, starts, counts,
                                    cs, ncx, H, W)
    if rec.device.type != "cuda":
        raise ValueError(f"mesh_fragments: unsupported device {rec.device}")
    if cell_ids.shape[0] == 0:     # no active cell: nothing to launch
        return _fill(H, W, rec.device)
    fn, args, out = raster_call(rec, entries, cell_ids, starts, counts, cs,
                                ncx, H, W)
    check_launch(fn(*args), "mesh_fragments")
    trace.count("mesh_raster_launches")
    return out[:3]
