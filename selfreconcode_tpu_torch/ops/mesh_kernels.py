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

Dispatch rule: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
goes to the kernel or raises.  ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ._cuda_build import CudaLibrary, check_launch


@dataclass
class LaunchCounts:
    """Kernel launches since the last reset (plain-version calls are not
    counted)."""
    mesh_raster_launches: int = 0

    def reset(self):
        self.mesh_raster_launches = 0


launches = LaunchCounts()

_MAX_PAIRS = 1 << 22   # (entry, pixel) pairs per chunk of the plain version


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.srt_mesh_raster.argtypes = [p, i, p, p, p, p, i, i, i, i, i, p, p, p,
                                    p]
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
        raise ValueError(f"cell size {cs} outside [1, 32] (cs*cs threads)")


def _fill(H: int, W: int, device):
    return (torch.full((H, W), float("inf"), device=device),
            torch.full((H, W), -1, dtype=torch.int32, device=device),
            torch.zeros((H, W, 3), device=device))


def _edge_bary(r, X, Y):
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
        b0, b1, b2, inside = _edge_bary(r, px.float(), py.float())
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
    b0, b1, b2, _ = _edge_bary(r, X, Y)
    t = torch.stack([b0 / r[:, 6], b1 / r[:, 7], b2 / r[:, 8]], dim=1)
    ts = (t[:, 0] + t[:, 1] + t[:, 2]).clamp_min(1e-12)
    face.reshape(-1)[hit] = f.to(torch.int32)
    bary.reshape(-1, 3)[hit] = t / ts[:, None]
    return zbuf, face, bary


def raster_call(rec, entries, cell_ids, starts, counts, cs: int, ncx: int,
                H: int, W: int):
    """One launch as (ctypes function, its arguments, the filled outputs
    (zbuf, face, bary)): the kernel alone, with the arguments prepared
    once."""
    zbuf, face, bary = _fill(H, W, rec.device)
    return LIB.load().srt_mesh_raster, (
        rec.data_ptr(), rec.shape[0], entries.data_ptr(), cell_ids.data_ptr(),
        starts.data_ptr(), counts.data_ptr(), cell_ids.shape[0], cs, ncx, H,
        W, zbuf.data_ptr(), face.data_ptr(), bary.data_ptr(),
        torch.cuda.current_stream(rec.device).cuda_stream), (zbuf, face, bary)


def mesh_fragments(rec, entries, cell_ids, starts, counts, cs: int, ncx: int,
                   H: int, W: int):
    """(zbuf, face, bary) images.  CPU -> plain version; CUDA -> the kernel
    (or an exception)."""
    _check_inputs(rec, entries, cell_ids, starts, counts, cs)
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
    launches.mesh_raster_launches += 1
    return out
