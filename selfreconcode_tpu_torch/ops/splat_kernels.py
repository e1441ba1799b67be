"""Splat soft-mask kernels: build, launch wrappers, plain versions, counters.

The two kernels in ``csrc/splat.cu`` replace the Pallas kernels
``splat_fwd_cells_idx`` and ``splat_bwd_cells_idx``
(``selfreconcode_tpu/ops/pallas_raster.py:231,287``).  They are compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/<content-hash>/libsrt_splat.so``
at first use and called through ``ctypes`` (``ops/_cuda_build.py``).  The
same two kernels also replace the dense-cell forms ``splat_fwd_cells`` and
``splat_bwd_cells`` (:176,342), which nothing in either package calls.

Both kernels walk the binned slot list that ``ops/rasterize.py::splat_bins``
builds, with a length the host knows without reading the device:

  entries   (S,) int32  sorted entry ids k * n_pts + point (k < 4), grouped
                        by cell in ascending cell order, the valid ones first
  ecell     (S,) int32  each entry's cell
  count     (1,) int32  the valid entries (read by the kernels on the device)
  starts    (C,) int32  first position of each cell's run, for every cell
  counts    (C,) int32  length of each cell's run (0 for an empty cell)

and cut its first ``count`` entries into chunks of ``CHUNK`` entries, one per
warp (the grid is sized by S; a warp past the count returns at once).  The
forward sums each cell's run chunk by chunk (a cell that crosses a chunk edge
gets one partial sum per chunk, added in chunk order) and writes the mask
1 - exp(acc) (or acc, for the dense form); the backward forms the
cotangent -g * (1 - mask) itself and writes each entry's gradient at its
entry id.  The plain versions compute the same functions in the same
summation grouping.

Dispatch rule: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
goes to the kernel or raises.  Each kernel launch (and nothing else) adds
one to a host counter of ``utils/trace.py``: ``splat_fwd_launches``,
``splat_bwd_launches``, and for the dense forms ``splat_fwd_cells_launches``
and ``splat_bwd_cells_launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import trace
from ._cuda_build import CudaLibrary, check_launch

BIG = 3.0e38     # the dense forms' empty-slot sentinel (col >= BIG / 2)
CHUNK = 32       # entries per chunk; splat.cu's kChunk, checked at load
W_MAX = 1.0 - 1e-5


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srt_splat_chunk.argtypes = []
    lib.srt_splat_chunk.restype = i
    if lib.srt_splat_chunk() != CHUNK:
        raise RuntimeError(f"splat.cu chunks {lib.srt_splat_chunk()} "
                           f"entries, splat_kernels.CHUNK is {CHUNK}")
    lib.srt_splat_fwd.argtypes = [p, p, i, p, p, i, p, p, p, i, i, i, i, i,
                                  f, f, i, p, p, p]
    lib.srt_splat_fwd.restype = i
    lib.srt_splat_bwd.argtypes = [p, p, i, p, p, i, p, i, i, i, i, f, f, p,
                                  p, p, p]
    lib.srt_splat_bwd.restype = i


LIB = CudaLibrary("splat.cu", "libsrt_splat", _bind)


def check_points(col, row):
    if col.dtype != torch.float32 or row.dtype != torch.float32:
        raise TypeError(f"col/row must be float32, got {col.dtype}, "
                        f"{row.dtype}")
    if col.dim() != 1 or row.shape != col.shape or row.device != col.device \
            or not (col.is_contiguous() and row.is_contiguous()):
        raise ValueError("col and row must be contiguous 1-D tensors of one "
                         "length on one device")


def check_bins(col, *index, cs: int):
    """entries, ecell, count[, starts, counts]: contiguous 1-D int32 on
    col's device, entries and ecell of one length, count of length 1, the
    per-cell tensors of one length."""
    for t in index:
        if t.device != col.device or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"bin tensors must be contiguous 1-D int32 on "
                             f"{col.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if index[0].shape != index[1].shape:
        raise ValueError("entries and ecell must have one length")
    if index[2].shape != (1,):
        raise ValueError("count must hold one value")
    if len(index) == 5 and index[3].shape != index[4].shape:
        raise ValueError("starts and counts must have one length")
    if not 1 <= cs <= 32:
        raise ValueError(f"cell size {cs} outside [1, 32]")


def _check_image(t, like, what):
    if t.device != like.device or t.dtype != torch.float32 or t.dim() != 2 \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous float32 2-D tensor on "
                         f"{like.device}")


def _r_box(r2_inv: float) -> float:
    """Half-width of the pixel box a splat can reach (w > 0 needs
    |dc|, |dr| < r), with 1e-3 px to spare for float32 rounding."""
    return float(r2_inv) ** -0.5 + 1e-3


# ---------------------------------------------------------------------------
# Plain versions: vectorized over (entry, pixel-of-cell) pairs
# ---------------------------------------------------------------------------

def decode(ids, n_pts: int):
    """Point of entry id k * n_pts + p (k < 4), as the kernels decode it."""
    k = (ids >= n_pts).long() + (ids >= 2 * n_pts) + (ids >= 3 * n_pts)
    return ids.long() - k * n_pts


def _pairs(col, row, entries, ecell, cs, ncx):
    """(M, P) pixel coordinates and distances for every entry x cell pixel."""
    pid = decode(entries, col.shape[0])
    cell = ecell.long()
    k = torch.arange(cs * cs, device=col.device)
    px = (cell % ncx * cs)[:, None] + k % cs                  # (M, P)
    py = (cell // ncx * cs)[:, None] + k // cs
    dc = col[pid][:, None] - px.to(col.dtype)
    dr = row[pid][:, None] - py.to(col.dtype)
    return px, py, dc, dr


def _valid(count, *slots):
    """The first `count` of each slot tensor (a host read of count)."""
    m = int(count)
    return [t[:m] for t in slots]


def splat_fwd_plain(col, row, entries, ecell, count, starts, counts,
                    cs: int, ncx: int, out_h: int, out_w: int, r2_inv: float,
                    to_mask: bool = True):
    """(out_h, out_w) image: 1 - exp(acc) (to_mask) or acc on the pixels
    of the cells with entries, 0 elsewhere.  acc sums log1p(-clip(w)) over
    the first `count` entries grouped as in the kernel: each run of one
    cell within one CHUNK-entry chunk (the kernel forms it as the log of the
    product of the (1 - w)), then a cell's chunk sums in chunk order."""
    out = torch.zeros((out_h, out_w), dtype=col.dtype, device=col.device)
    entries, ecell = _valid(count, entries, ecell)
    M = entries.shape[0]
    if M == 0:
        return out
    px, py, dc, dr = _pairs(col, row, entries, ecell, cs, ncx)
    w = 1.0 - (dc * dc + dr * dr) * r2_inv
    lt = torch.log1p(-w.clamp(0.0, W_MAX))
    chunk = torch.arange(M, device=col.device) // CHUNK
    head = torch.ones(M, dtype=torch.bool, device=col.device)
    head[1:] = (ecell[1:] != ecell[:-1]) | (chunk[1:] != chunk[:-1])
    seg = torch.cumsum(head, 0) - 1
    part = lt.new_zeros((int(seg[-1]) + 1, cs * cs)).index_add_(0, seg, lt)
    seg_cell = ecell[head]
    first = torch.ones_like(seg_cell, dtype=torch.bool)
    first[1:] = seg_cell[1:] != seg_cell[:-1]
    acc = part.new_zeros((int(first.sum()), cs * cs)).index_add_(
        0, torch.cumsum(first, 0) - 1, part)
    lead = head.nonzero().squeeze(1)[first]       # each cell's first entry
    px, py = px[lead], py[lead]
    inb = (px < out_w) & (py < out_h)
    val = 1.0 - torch.exp(acc) if to_mask else acc
    out.reshape(-1)[(py * out_w + px)[inb]] = val[inb]
    return out


def splat_bwd_plain(col, row, entries, ecell, count, g_img, mask_img,
                    cs: int, ncx: int, r2_inv: float, n_slots: int):
    """(n_slots, 2): at row e the (d col, d row) of entry id e among the
    first `count` entries, 0 on ids no such entry has.  The cotangent is
    -g * (1 - mask) on g_img's pixels (g_img itself when mask_img is None)
    and 0 beyond them."""
    entries, ecell = _valid(count, entries, ecell)
    h, w_img = g_img.shape
    cot_img = g_img if mask_img is None else -g_img * (1.0 - mask_img)
    px, py, dc, dr = _pairs(col, row, entries, ecell, cs, ncx)
    inb = (px < w_img) & (py < h)
    cot = torch.where(inb, cot_img.reshape(-1)[
        (py * w_img + px).clamp(max=h * w_img - 1)], torch.zeros_like(dc))
    w = 1.0 - (dc * dc + dr * dr) * r2_inv
    act = (w > 0.0) & (w < W_MAX)
    coef = torch.where(act, 2.0 * r2_inv / (1.0 - w.clamp(0.0, W_MAX)),
                       torch.zeros_like(w)) * cot
    out = col.new_zeros((n_slots, 2))
    out[entries.long()] = torch.stack([(coef * dc).sum(1),
                                       (coef * dr).sum(1)], dim=1)
    return out


# ---------------------------------------------------------------------------
# Raw launches and wrappers
# ---------------------------------------------------------------------------

def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_call(col, row, entries, ecell, count, starts, counts, cs, ncx,
             out_h, out_w, r2_inv, to_mask=True):
    """One forward launch as (ctypes function, its arguments, (the output,
    the scratch of per-chunk partial sums)): the kernel alone, with the
    arguments prepared once.  Keep the buffers while the launch may run."""
    out = torch.zeros((out_h, out_w), dtype=torch.float32, device=col.device)
    chunks = -(-entries.shape[0] // CHUNK)
    partial = torch.empty((chunks, 2, cs * cs), dtype=torch.float32,
                          device=col.device)
    return LIB.load().srt_splat_fwd, (
        col.data_ptr(), row.data_ptr(), col.shape[0], entries.data_ptr(),
        ecell.data_ptr(), entries.shape[0], count.data_ptr(),
        starts.data_ptr(), counts.data_ptr(), starts.shape[0], cs, ncx,
        out_h, out_w, float(r2_inv), _r_box(r2_inv), int(to_mask),
        partial.data_ptr(), out.data_ptr(), _stream(col)), (out, partial)


def bwd_call(col, row, entries, ecell, count, g_img, mask_img, cs, ncx,
             r2_inv, n_slots):
    """One backward launch as (ctypes function, its arguments, the
    output)."""
    g = torch.zeros((n_slots, 2), dtype=torch.float32, device=col.device)
    h, w = g_img.shape
    return LIB.load().srt_splat_bwd, (
        col.data_ptr(), row.data_ptr(), col.shape[0], entries.data_ptr(),
        ecell.data_ptr(), entries.shape[0], count.data_ptr(), cs, ncx, h, w,
        float(r2_inv), _r_box(r2_inv), g_img.data_ptr(),
        None if mask_img is None else mask_img.data_ptr(), g.data_ptr(),
        _stream(col)), g


def _require_cuda(t, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def fwd(col, row, entries, ecell, count, starts, counts, cs, ncx, out_h,
        out_w, r2_inv, to_mask=True, counter="splat_fwd_launches"):
    """The forward on checked inputs.  CPU -> plain version; CUDA -> the
    kernel (or an exception), counted in the host counter `counter`; with
    no slot nothing is launched."""
    if col.device.type == "cpu":
        return splat_fwd_plain(col, row, entries, ecell, count, starts,
                               counts, cs, ncx, out_h, out_w, r2_inv, to_mask)
    _require_cuda(col, "splat_fwd")
    fn, args, (out, partial) = fwd_call(col, row, entries, ecell, count,
                                        starts, counts, cs, ncx, out_h,
                                        out_w, r2_inv, to_mask)
    if entries.shape[0] == 0:
        return out
    check_launch(fn(*args), "splat_fwd")
    trace.count(counter)
    del partial      # freed only now: the launch that uses it is queued
    return out


def bwd(col, row, entries, ecell, count, g_img, mask_img, cs, ncx, r2_inv,
        n_slots, counter="splat_bwd_launches"):
    """The backward on checked inputs: per-slot gradients.  A launch is
    counted in the host counter `counter`."""
    if col.device.type == "cpu":
        return splat_bwd_plain(col, row, entries, ecell, count, g_img,
                               mask_img, cs, ncx, r2_inv, n_slots)
    _require_cuda(col, "splat_bwd")
    fn, args, g = bwd_call(col, row, entries, ecell, count, g_img, mask_img,
                           cs, ncx, r2_inv, n_slots)
    if entries.shape[0] == 0:
        return g
    check_launch(fn(*args), "splat_bwd")
    trace.count(counter)
    return g


def splat_fwd(col, row, entries, ecell, count, starts, counts, cs: int,
              ncx: int, out_h: int, out_w: int, r2_inv: float,
              to_mask: bool = True):
    """Mask (or accumulator) image (out_h, out_w), checked inputs.  CPU ->
    plain version; CUDA -> the kernel (or an exception)."""
    check_points(col, row)
    check_bins(col, entries, ecell, count, starts, counts, cs=cs)
    return fwd(col, row, entries, ecell, count, starts, counts, cs, ncx,
               out_h, out_w, r2_inv, to_mask)


def splat_bwd(col, row, entries, ecell, count, g_img, mask_img, cs: int,
              ncx: int, r2_inv: float, n_slots: int):
    """Per-slot gradients (n_slots, 2), checked inputs.  CPU -> plain
    version; CUDA -> the kernel (or an exception)."""
    check_points(col, row)
    check_bins(col, entries, ecell, count, cs=cs)
    _check_image(g_img, col, "g_img")
    if mask_img is not None:
        _check_image(mask_img, col, "mask_img")
        if mask_img.shape != g_img.shape:
            raise ValueError("mask_img and g_img must have one shape")
    return bwd(col, row, entries, ecell, count, g_img, mask_img, cs, ncx,
               r2_inv, n_slots)


# ---------------------------------------------------------------------------
# Dense-cell forms: replace ``splat_fwd_cells`` / ``splat_bwd_cells``
# (pallas_raster.py:176,342).  Cell c of a (C, 2, cap) slot tensor is cell c
# of the grid; its entries are the slots with col < BIG / 2 in slot order,
# with slot ids as entry ids (k = 0), listed at their exact length.  Same
# kernels as above, with the accumulator image relaid to the cell-major
# (C, cs*cs) layout and the gradient written straight into the slots.
# ---------------------------------------------------------------------------

def dense_bins(pts, cs: int, ncx: int):
    """((col, row, entries, ecell, count, starts, counts), hp, wp) of a
    (C, 2, cap) slot tensor: the filled slots alone (a host read of their
    number, which sizes the grids)."""
    if pts.dtype != torch.float32 or pts.dim() != 3 or pts.shape[1] != 2:
        raise ValueError(f"pts must be float32 (C, 2, cap), got "
                         f"{pts.dtype} {tuple(pts.shape)}")
    C, _, cap = pts.shape
    col = pts[:, 0].reshape(-1).contiguous()
    row = pts[:, 1].reshape(-1).contiguous()
    valid = col < BIG / 2
    counts = valid.reshape(C, cap).sum(1, dtype=torch.int32)
    starts = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    count = counts.sum(dtype=torch.int32).reshape(1)
    entries = torch.nonzero(valid).squeeze(1).to(torch.int32)
    ecell = torch.div(entries, cap, rounding_mode="floor")
    ncy = -(-C // ncx)
    return ((col, row, entries, ecell, count, starts, counts), ncy * cs,
            ncx * cs)


def _image_to_cells(img, C: int, cs: int, ncx: int):
    ncy = img.shape[0] // cs
    return img.reshape(ncy, cs, ncx, cs).permute(0, 2, 1, 3).reshape(
        ncy * ncx, cs * cs)[:C]


def cells_to_image(cells, cs: int, ncx: int):
    C = cells.shape[0]
    ncy = -(-C // ncx)
    full = cells.new_zeros((ncy * ncx, cs * cs))
    full[:C] = cells
    return full.reshape(ncy, ncx, cs, cs).permute(0, 2, 1, 3).reshape(
        ncy * cs, ncx * cs).contiguous()


def _dense_fwd(pts, cs: int, ncx: int, r_pix: float, run):
    bins, hp, wp = dense_bins(pts, cs, ncx)
    acc = run(*bins, cs, ncx, hp, wp, 1.0 / float(r_pix * r_pix), False)
    return _image_to_cells(acc, pts.shape[0], cs, ncx)


def _dense_bwd(pts, cot, cs: int, ncx: int, r_pix: float, run):
    C, _, cap = pts.shape
    bins, _, _ = dense_bins(pts, cs, ncx)
    g = run(*bins[:5], cells_to_image(cot, cs, ncx), None, cs, ncx,
            1.0 / float(r_pix * r_pix), C * cap)
    return g.reshape(C, cap, 2).permute(0, 2, 1).contiguous()


def splat_fwd_cells_plain(pts, cs: int, ncx: int, r_pix: float):
    return _dense_fwd(pts, cs, ncx, r_pix, splat_fwd_plain)


def splat_bwd_cells_plain(pts, cot, cs: int, ncx: int, r_pix: float):
    return _dense_bwd(pts, cot, cs, ncx, r_pix, splat_bwd_plain)


def splat_fwd_cells(pts, cs: int, ncx: int, r_pix: float):
    """pts (C, 2, cap) -> accumulated log1p(-w) (C, cs*cs).  CPU -> plain
    version; CUDA -> the forward kernel (or an exception)."""
    return _dense_fwd(pts, cs, ncx, r_pix, functools.partial(
        fwd, counter="splat_fwd_cells_launches"))


def splat_bwd_cells(pts, cot, cs: int, ncx: int, r_pix: float):
    """pts (C, 2, cap), cot (C, cs*cs) -> per-slot (d col, d row)
    (C, 2, cap), zero on empty slots.  CPU -> plain version; CUDA -> the
    backward kernel (or an exception)."""
    return _dense_bwd(pts, cot, cs, ncx, r_pix, functools.partial(
        bwd, counter="splat_bwd_cells_launches"))
