"""Point-splat soft silhouette (torch port of
``selfreconcode_tpu/ops/rasterize.py::splat_mask``).

With unit features, alpha-compositing the splats that cover a pixel equals
1 - prod_k (1 - w_k), w = 1 - d^2/r^2, which is order-independent: the mask
is 1 - exp(sum_k log1p(-w_k)).  Splats are binned into cs x cs image cells
(a splat's bbox is at most one cell wide, so it touches at most 2x2 cells);
the forward kernel sums each active cell's whole candidate run per pixel and
the backward kernel returns per-entry (d col, d row), which torch reduces
per point in a fixed order.  There is no candidate capacity: the port drops
no splat, so it equals the JAX mask wherever the JAX binning drops nothing
(its ``stats[0] == 0``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..render.camera import Camera, transform_points_screen
from .binning import bbox_cell_entries
from . import splat_kernels as SK


class SplatBins(NamedTuple):
    entries: torch.Tensor    # (M,) int32 valid entries sorted by cell
    cell_ids: torch.Tensor   # (A,) int32 active cells, ascending
    starts: torch.Tensor     # (A,) int32 run starts into `entries`
    counts: torch.Tensor     # (A,) int32 run lengths
    cs: int
    ncx: int
    hp: int
    wp: int


def _cell_geometry(H: int, W: int, cs: int):
    ncy = -(-H // cs)
    ncx = -(-W // cs)
    return ncy, ncx, ncy * cs, ncx * cs


def splat_bins(col, row, z, point_valid, r_pix: float, H: int, W: int,
               cs: int) -> SplatBins:
    """Sort the splats' 2x2 cell entries by cell (no capacity, no drops)."""
    ncy, ncx, hp, wp = _cell_geometry(H, W, cs)
    half = r_pix
    ok = (point_valid & (z > 0.0) & (col + half >= 0) & (col - half <= W - 1)
          & (row + half >= 0) & (row - half <= H - 1))
    cells, evalid = bbox_cell_entries(col - half, row - half, col + half,
                                      row + half, ok, cs, ncx, ncy)
    idx = torch.nonzero(evalid).squeeze(1)
    order = torch.argsort(cells[idx], stable=True)
    entries = idx[order].to(torch.int32)
    per_cell = torch.bincount(cells[idx].long(), minlength=ncy * ncx)
    cell_ids = torch.nonzero(per_cell).squeeze(1)
    counts = per_cell[cell_ids]
    starts = torch.cumsum(counts, 0) - counts
    return SplatBins(entries.contiguous(), cell_ids.to(torch.int32),
                     starts.to(torch.int32), counts.to(torch.int32),
                     cs, ncx, hp, wp)


class _SplatMask(torch.autograd.Function):
    """mask (H, W) from screen (col, row); gradients go to col/row only."""

    @staticmethod
    def forward(ctx, col, row, z, point_valid, r_pix: float, H: int, W: int,
                cs: int):
        with torch.no_grad():
            bins = splat_bins(col, row, z, point_valid, r_pix, H, W, cs)
            r2_inv = 1.0 / float(r_pix * r_pix)
            acc = SK.splat_fwd(col.contiguous(), row.contiguous(),
                               bins.entries, bins.cell_ids, bins.starts,
                               bins.counts, cs, bins.ncx, bins.hp, bins.wp,
                               r2_inv)
            mask = 1.0 - torch.exp(acc[:H, :W])
            occ = bins.counts.max() if bins.counts.numel() else \
                torch.zeros((), dtype=torch.int32, device=col.device)
            stats = torch.stack([occ.to(torch.int64),
                                 torch.tensor(bins.cell_ids.numel(),
                                              device=col.device)])
        ctx.save_for_backward(col, row, mask, bins.entries, bins.cell_ids,
                              bins.starts, bins.counts)
        ctx.geom = (cs, bins.ncx, bins.hp, bins.wp, r2_inv)
        ctx.mark_non_differentiable(stats)
        return mask, stats

    @staticmethod
    def backward(ctx, g, _g_stats):
        col, row, mask, entries, cell_ids, starts, counts = ctx.saved_tensors
        cs, ncx, hp, wp, r2_inv = ctx.geom
        H, W = mask.shape
        cot = torch.zeros((hp, wp), dtype=torch.float32, device=col.device)
        cot[:H, :W] = -g * (1.0 - mask)
        g_sorted = SK.splat_bwd(col.contiguous(), row.contiguous(), entries,
                                cell_ids, starts, counts, cot, cs, ncx,
                                r2_inv)
        n = col.shape[0]
        g_entry = torch.zeros((4 * n, 2), dtype=g_sorted.dtype,
                              device=col.device)
        g_entry[entries.long()] = g_sorted
        g_pts = g_entry.reshape(4, n, 2).sum(0)
        return g_pts[:, 0], g_pts[:, 1], None, None, None, None, None, None


def splat_cell_size(r_pix: float, footprint: int) -> int:
    """8 px cells when the splat fits one (the slice's path); otherwise the
    JAX fallback's max(8, footprint) cells."""
    cs = 8 if 2.0 * r_pix <= 8.0 else max(8, int(footprint))
    if 2.0 * r_pix > cs:
        raise ValueError(f"splat diameter {2 * r_pix:.2f} px exceeds the "
                         f"{cs} px cell (raise footprint)")
    return cs


def splat_mask(cam: Camera, points: torch.Tensor, point_valid: torch.Tensor,
               radius_ndc: float, footprint: int = 9,
               return_stats: bool = False):
    """Soft mask (H, W) in [0, 1] from world-space points (N, 3).

    Differentiable w.r.t. the points and the camera (through the screen
    transform).  return_stats=True also returns a (2,) int64 tensor
    [max cell occupancy, active cell count]."""
    r_pix = radius_ndc * cam.W / 2.0
    cs = splat_cell_size(r_pix, footprint)
    screen = transform_points_screen(cam, points)
    col, row, z = screen[:, 0], screen[:, 1], screen[:, 2]
    mask, stats = _SplatMask.apply(col, row, z.detach(), point_valid,
                                   float(r_pix), cam.H, cam.W, cs)
    return (mask, stats) if return_stats else mask
