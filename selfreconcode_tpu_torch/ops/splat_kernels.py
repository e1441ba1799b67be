"""Splat soft-mask kernels: build, launch wrappers, plain versions, counters.

The two kernels in ``csrc/splat.cu`` replace the Pallas kernels
``splat_fwd_cells_idx`` and ``splat_bwd_cells_idx``
(``selfreconcode_tpu/ops/pallas_raster.py:231,287``).  They are compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/<content-hash>/libsrt_splat.so``
at first use and called through ``ctypes`` (``ops/_cuda_build.py``).  The
same two kernels also replace the dense-cell forms ``splat_fwd_cells`` and
``splat_bwd_cells`` (:176,342), which nothing in either package calls.

Both kernels walk the binned entry list that ``ops/rasterize.py`` builds:

  entries   (M,) int32  sorted entry ids (entry mod n_pts = point id),
                        grouped by cell in ascending cell order
  cell_ids  (A,) int32  the active cells (every cell with an entry)
  starts    (A,) int32  first position of each active cell's run
  counts    (A,) int32  length of each active cell's run

Dispatch rule: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
goes to the kernel or raises.  ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ._cuda_build import CudaLibrary, check_launch

BIG = 3.0e38   # the dense forms' empty-slot sentinel (col >= BIG / 2)


@dataclass
class LaunchCounts:
    """Kernel launches since the last reset (plain-version calls are not
    counted)."""
    splat_fwd_launches: int = 0
    splat_bwd_launches: int = 0
    splat_fwd_cells_launches: int = 0
    splat_bwd_cells_launches: int = 0

    def reset(self):
        for name in self.__dataclass_fields__:
            setattr(self, name, 0)


launches = LaunchCounts()


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srt_splat_fwd.argtypes = [p, p, i, p, p, p, p, i, i, i, i, f, p, p]
    lib.srt_splat_fwd.restype = ctypes.c_int
    lib.srt_splat_bwd.argtypes = [p, p, i, p, p, p, p, i, i, i, i, f, p, p,
                                  p]
    lib.srt_splat_bwd.restype = ctypes.c_int


LIB = CudaLibrary("splat.cu", "libsrt_splat", _bind)


def _check_inputs(col, row, entries, cell_ids, starts, counts, cs):
    dev = col.device
    for name, t, dt in (("col", col, torch.float32), ("row", row, torch.float32),
                        ("entries", entries, torch.int32),
                        ("cell_ids", cell_ids, torch.int32),
                        ("starts", starts, torch.int32),
                        ("counts", counts, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, col on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                             f"shape {tuple(t.shape)}")
    if row.shape != col.shape:
        raise ValueError(f"row {tuple(row.shape)} != col {tuple(col.shape)}")
    if not (cell_ids.shape == starts.shape == counts.shape):
        raise ValueError("cell_ids, starts and counts must have one length")
    if not 1 <= cs <= 32:
        raise ValueError(f"cell size {cs} outside [1, 32] (cs*cs threads)")


# ---------------------------------------------------------------------------
# Plain versions: vectorized over (entry, pixel-of-cell) pairs
# ---------------------------------------------------------------------------

def _pairs(col, row, entries, cell_ids, counts, cs, ncx):
    """(M, P) pixel coordinates and distances for every entry x cell pixel."""
    n_pts = col.shape[0]
    pid = entries.long() % n_pts
    cell = torch.repeat_interleave(cell_ids.long(), counts.long())
    k = torch.arange(cs * cs, device=col.device)
    px = (cell % ncx * cs)[:, None] + k % cs                  # (M, P)
    py = (cell // ncx * cs)[:, None] + k // cs
    dc = col[pid][:, None] - px.to(col.dtype)
    dr = row[pid][:, None] - py.to(col.dtype)
    return px, py, dc, dr


def splat_fwd_plain(col, row, entries, cell_ids, starts, counts, cs: int,
                    ncx: int, hp: int, wp: int, r2_inv: float):
    """Accumulated log1p(-clip(w)) image (hp, wp); zero outside active cells."""
    px, py, dc, dr = _pairs(col, row, entries, cell_ids, counts, cs, ncx)
    w = 1.0 - (dc * dc + dr * dr) * r2_inv
    lt = torch.log1p(-w.clamp(0.0, 1.0 - 1e-5))
    acc = torch.zeros(hp * wp, dtype=col.dtype, device=col.device)
    acc.index_add_(0, (py * wp + px).reshape(-1), lt.reshape(-1))
    return acc.reshape(hp, wp)


def splat_bwd_plain(col, row, entries, cell_ids, starts, counts, cot_img,
                    cs: int, ncx: int, r2_inv: float):
    """Per-entry (gcol, grow), (M, 2), in sorted-entry order."""
    wp = cot_img.shape[1]
    px, py, dc, dr = _pairs(col, row, entries, cell_ids, counts, cs, ncx)
    w = 1.0 - (dc * dc + dr * dr) * r2_inv
    act = (w > 0.0) & (w < 1.0 - 1e-5)
    cot = cot_img.reshape(-1)[py * wp + px]
    coef = torch.where(act, 2.0 * r2_inv / (1.0 - w.clamp(0.0, 1.0 - 1e-5)),
                       torch.zeros_like(w)) * cot
    return torch.stack([(coef * dc).sum(1), (coef * dr).sum(1)], dim=1)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _require_cuda(t, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def _launch_fwd(col, row, entries, cell_ids, starts, counts, cs, ncx, hp, wp,
                r2_inv):
    """(acc, launched): with no active cell nothing is launched."""
    acc = torch.zeros((hp, wp), dtype=torch.float32, device=col.device)
    if cell_ids.shape[0] == 0:
        return acc, False
    err = LIB.load().srt_splat_fwd(
        col.data_ptr(), row.data_ptr(), col.shape[0], entries.data_ptr(),
        cell_ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        cell_ids.shape[0], cs, ncx, wp, float(r2_inv), acc.data_ptr(),
        torch.cuda.current_stream(col.device).cuda_stream)
    check_launch(err, "splat_fwd")
    return acc, True


def _launch_bwd(col, row, entries, cell_ids, starts, counts, cot_img, cs, ncx,
                r2_inv):
    """(g, launched): with no active cell nothing is launched."""
    g = torch.empty((entries.shape[0], 2), dtype=torch.float32,
                    device=col.device)
    if cell_ids.shape[0] == 0:
        return g, False
    err = LIB.load().srt_splat_bwd(
        col.data_ptr(), row.data_ptr(), col.shape[0], entries.data_ptr(),
        cell_ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        cell_ids.shape[0], cs, ncx, cot_img.shape[1], float(r2_inv),
        cot_img.data_ptr(), g.data_ptr(),
        torch.cuda.current_stream(col.device).cuda_stream)
    check_launch(err, "splat_bwd")
    return g, True


def _check_cot(cot_img, col):
    if cot_img.device != col.device or cot_img.dtype != torch.float32 \
            or cot_img.dim() != 2 or not cot_img.is_contiguous():
        raise ValueError("cot_img must be a contiguous float32 (hp, wp) "
                         "tensor on col's device")


def splat_fwd(col, row, entries, cell_ids, starts, counts, cs: int, ncx: int,
              hp: int, wp: int, r2_inv: float):
    """Forward accumulator image (hp, wp).  CPU -> plain version; CUDA ->
    the kernel (or an exception)."""
    _check_inputs(col, row, entries, cell_ids, starts, counts, cs)
    if col.device.type == "cpu":
        return splat_fwd_plain(col, row, entries, cell_ids, starts, counts,
                               cs, ncx, hp, wp, r2_inv)
    _require_cuda(col, "splat_fwd")
    acc, ran = _launch_fwd(col, row, entries, cell_ids, starts, counts, cs,
                           ncx, hp, wp, r2_inv)
    launches.splat_fwd_launches += ran
    return acc


def splat_bwd(col, row, entries, cell_ids, starts, counts, cot_img, cs: int,
              ncx: int, r2_inv: float):
    """Per-entry gradients (M, 2) in sorted-entry order.  CPU -> plain
    version; CUDA -> the kernel (or an exception)."""
    _check_inputs(col, row, entries, cell_ids, starts, counts, cs)
    _check_cot(cot_img, col)
    if col.device.type == "cpu":
        return splat_bwd_plain(col, row, entries, cell_ids, starts, counts,
                               cot_img, cs, ncx, r2_inv)
    _require_cuda(col, "splat_bwd")
    g, ran = _launch_bwd(col, row, entries, cell_ids, starts, counts, cot_img,
                         cs, ncx, r2_inv)
    launches.splat_bwd_launches += ran
    return g


# ---------------------------------------------------------------------------
# Dense-cell forms: replace ``splat_fwd_cells`` / ``splat_bwd_cells``
# (pallas_raster.py:176,342).  Every cell c of a (C, 2, cap) slot tensor is
# active with grid index c; its entries are the slots with col < BIG / 2 in
# slot order.  Same kernels as above, with the image relaid to and from the
# cell-major (C, cs*cs) layout.
# ---------------------------------------------------------------------------

def _dense_bins(pts, cs: int, ncx: int):
    if pts.dtype != torch.float32 or pts.dim() != 3 or pts.shape[1] != 2:
        raise ValueError(f"pts must be float32 (C, 2, cap), got "
                         f"{pts.dtype} {tuple(pts.shape)}")
    C, _, cap = pts.shape
    col = pts[:, 0].reshape(-1).contiguous()
    row = pts[:, 1].reshape(-1).contiguous()
    valid = col < BIG / 2
    counts = valid.reshape(C, cap).sum(1, dtype=torch.int32)
    starts = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    entries = torch.nonzero(valid).squeeze(1).to(torch.int32)
    cell_ids = torch.arange(C, dtype=torch.int32, device=pts.device)
    ncy = -(-C // ncx)
    return (col, row, entries, cell_ids, starts, counts), ncy * cs, ncx * cs


def _image_to_cells(img, C: int, cs: int, ncx: int):
    ncy = img.shape[0] // cs
    return img.reshape(ncy, cs, ncx, cs).permute(0, 2, 1, 3).reshape(
        ncy * ncx, cs * cs)[:C]


def _cells_to_image(cells, cs: int, ncx: int):
    C = cells.shape[0]
    ncy = -(-C // ncx)
    full = cells.new_zeros((ncy * ncx, cs * cs))
    full[:C] = cells
    return full.reshape(ncy, ncx, cs, cs).permute(0, 2, 1, 3).reshape(
        ncy * cs, ncx * cs).contiguous()


def _scatter_slots(g_sorted, entries, pts):
    """Per-entry (M, 2) -> (C, 2, cap), zero on empty slots."""
    C, _, cap = pts.shape
    out = g_sorted.new_zeros((C * cap, 2))
    out[entries.long()] = g_sorted
    return out.reshape(C, cap, 2).permute(0, 2, 1).contiguous()


def splat_fwd_cells_plain(pts, cs: int, ncx: int, r_pix: float):
    bins, hp, wp = _dense_bins(pts, cs, ncx)
    acc = splat_fwd_plain(*bins, cs, ncx, hp, wp, 1.0 / float(r_pix * r_pix))
    return _image_to_cells(acc, pts.shape[0], cs, ncx)


def splat_bwd_cells_plain(pts, cot, cs: int, ncx: int, r_pix: float):
    bins, _, _ = _dense_bins(pts, cs, ncx)
    g = splat_bwd_plain(*bins, _cells_to_image(cot, cs, ncx), cs, ncx,
                        1.0 / float(r_pix * r_pix))
    return _scatter_slots(g, bins[2], pts)


def splat_fwd_cells(pts, cs: int, ncx: int, r_pix: float):
    """pts (C, 2, cap) -> accumulated log1p(-w) (C, cs*cs).  CPU -> plain
    version; CUDA -> the forward kernel (or an exception)."""
    if pts.device.type == "cpu":
        return splat_fwd_cells_plain(pts, cs, ncx, r_pix)
    _require_cuda(pts, "splat_fwd_cells")
    bins, hp, wp = _dense_bins(pts, cs, ncx)
    _check_inputs(*bins, cs)
    acc, ran = _launch_fwd(*bins, cs, ncx, hp, wp, 1.0 / float(r_pix * r_pix))
    launches.splat_fwd_cells_launches += ran
    return _image_to_cells(acc, pts.shape[0], cs, ncx)


def splat_bwd_cells(pts, cot, cs: int, ncx: int, r_pix: float):
    """pts (C, 2, cap), cot (C, cs*cs) -> per-slot (d col, d row)
    (C, 2, cap), zero on empty slots.  CPU -> plain version; CUDA -> the
    backward kernel (or an exception)."""
    if pts.device.type == "cpu":
        return splat_bwd_cells_plain(pts, cot, cs, ncx, r_pix)
    _require_cuda(pts, "splat_bwd_cells")
    bins, _, _ = _dense_bins(pts, cs, ncx)
    _check_inputs(*bins, cs)
    cot_img = _cells_to_image(cot, cs, ncx)
    _check_cot(cot_img, bins[0])
    g, ran = _launch_bwd(*bins, cot_img, cs, ncx, 1.0 / float(r_pix * r_pix))
    launches.splat_bwd_cells_launches += ran
    return _scatter_slots(g, bins[2], pts)
