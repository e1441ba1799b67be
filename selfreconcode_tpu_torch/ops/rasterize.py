"""Point-splat soft silhouette (torch port of
``selfreconcode_tpu/ops/rasterize.py::splat_mask``).

With unit features, alpha-compositing the splats that cover a pixel equals
1 - prod_k (1 - w_k), w = 1 - d^2/r^2, which is order-independent: the mask
is 1 - exp(sum_k log1p(-w_k)).  Splats are binned into cs x cs image cells
(a splat's bbox is at most one cell wide, so it touches at most 2x2 cells);
the forward kernel sums each active cell's whole candidate run per pixel and
writes the mask, and the backward kernel writes each entry's (d col, d row)
at its entry id, whose <= 4 slots per point torch sums in a fixed order.
There is no candidate capacity: the port drops no splat, so it equals the
JAX mask wherever the JAX binning drops nothing (its ``stats[0] == 0``).
The binning reads four values on the host (the entry count, bincount's
least and largest cell, the active cells), each counted in ``host_syncs``
(``utils/trace.py``).

Mesh fragments (torch port of ``rasterize_mesh``): the nearest face per
pixel with its perspective-correct barycentrics and depth, non-
differentiable.  Triangles are binned the same way into cs x cs cells, a
triangle wider than a cell into every cell it covers (JAX bins 2x2 cells at
most and drops the rest), and the kernel of ``ops/mesh_kernels.py`` scans
each active cell's whole run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..render.camera import Camera, transform_points_screen
from ..utils import trace
from .binning import bbox_cell_entries
from . import mesh_kernels as MK
from . import splat_kernels as SK


class CellBins(NamedTuple):
    entries: torch.Tensor    # (M,) int32 valid entries sorted by cell
    ecell: torch.Tensor      # (M,) int32 each sorted entry's cell
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


def cell_bins(bb_min_x, bb_min_y, bb_max_x, bb_max_y, ok, H: int, W: int,
              cs: int) -> CellBins:
    """Bin every primitive into each cs x cs cell its bbox covers and sort
    the entries by (cell, entry id): within a cell in entry order, as JAX's
    stable sort_key_val leaves its 2x2 entries.  No capacity, no drops."""
    ncy, ncx, hp, wp = _cell_geometry(H, W, cs)
    cells, ids = bbox_cell_entries(bb_min_x, bb_min_y, bb_max_x, bb_max_y,
                                   ok, cs, ncx, ncy)
    order = torch.argsort(cells * (4 * bb_min_x.shape[0]) + ids)
    trace.count("host_syncs", 3)     # bincount's min and max, the nonzero
    per_cell = torch.bincount(cells, minlength=ncy * ncx)
    cell_ids = torch.nonzero(per_cell).squeeze(1)
    counts = per_cell[cell_ids]
    starts = torch.cumsum(counts, 0) - counts
    return CellBins(ids[order].to(torch.int32),
                    cells[order].to(torch.int32), cell_ids.to(torch.int32),
                    starts.to(torch.int32), counts.to(torch.int32),
                    cs, ncx, hp, wp)


def splat_bins(col, row, z, point_valid, r_pix: float, H: int, W: int,
               cs: int) -> CellBins:
    """The splats' cell bins (a splat's bbox is its centre +- r_pix)."""
    half = r_pix
    ok = (point_valid & (z > 0.0) & (col + half >= 0) & (col - half <= W - 1)
          & (row + half >= 0) & (row - half <= H - 1))
    return cell_bins(col - half, row - half, col + half, row + half, ok, H,
                     W, cs)


class _SplatMask(torch.autograd.Function):
    """mask (H, W) from screen (col, row); gradients go to col/row only.
    The inputs are checked once here (the bins are built here); SK.fwd and
    SK.bwd take them unchecked."""

    @staticmethod
    def forward(ctx, col, row, z, point_valid, r_pix: float, H: int, W: int,
                cs: int):
        with torch.no_grad():
            col, row = col.contiguous(), row.contiguous()
            SK.check_points(col, row)
            bins = splat_bins(col, row, z, point_valid, r_pix, H, W, cs)
            r2_inv = 1.0 / float(r_pix * r_pix)
            mask = SK.fwd(col, row, bins.entries, bins.ecell, bins.cell_ids,
                          bins.starts, bins.counts, cs, bins.ncx, H, W,
                          r2_inv)
        ctx.save_for_backward(col, row, mask, bins.entries, bins.ecell)
        ctx.geom = (cs, bins.ncx, r2_inv)
        return mask

    @staticmethod
    def backward(ctx, g):
        col, row, mask, entries, ecell = ctx.saved_tensors
        cs, ncx, r2_inv = ctx.geom
        n = col.shape[0]
        g_slots = SK.bwd(col, row, entries, ecell,
                         g.to(torch.float32).contiguous(), mask, cs, ncx,
                         r2_inv, 4 * n)
        g_pts = g_slots.reshape(4, n, 2).sum(0)
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
               radius_ndc: float, footprint: int = 9):
    """Soft mask (H, W) in [0, 1] from world-space points (N, 3).

    Differentiable w.r.t. the points and the camera (through the screen
    transform)."""
    r_pix = radius_ndc * cam.W / 2.0
    cs = splat_cell_size(r_pix, footprint)
    screen = transform_points_screen(cam, points)
    col, row, z = screen[:, 0], screen[:, 1], screen[:, 2]
    return _SplatMask.apply(col, row, z.detach(), point_valid, float(r_pix),
                            cam.H, cam.W, cs)


# ---------------------------------------------------------------------------
# Mesh fragments
# ---------------------------------------------------------------------------

class Fragments(NamedTuple):
    pix_to_face: torch.Tensor  # (H, W) int32, -1 for empty
    bary: torch.Tensor         # (H, W, 3) perspective-correct barycentrics
    zbuf: torch.Tensor         # (H, W) depth (+inf empty)


def mesh_cell_size(footprint: int) -> int:
    """The JAX Pallas path's cells (8 px up to footprint 8, 16 up to 16),
    then max(8, footprint) up to 32 (the kernel keeps one key per cell
    pixel in shared memory, <= 1024)."""
    fp = int(footprint)
    cs = 8 if fp <= 8 else 16 if fp <= 16 else fp
    if cs > 32:
        raise ValueError(f"footprint {fp} px needs {fp} px cells; the mesh "
                         f"kernel takes at most 32 (cs*cs <= 1024 keys)")
    return cs


def mesh_bins(cam: Camera, verts: torch.Tensor, faces: torch.Tensor,
              footprint: int = 8):
    """The mesh kernel's inputs: (face records (F, 9) = screen p0 p1 p2 and
    camera depths z0 z1 z2, CellBins of the faces in front of the camera
    and on screen)."""
    H, W = cam.H, cam.W
    screen = transform_points_screen(cam, verts)
    f0, f1, f2 = (faces[:, i].long() for i in range(3))
    p0, p1, p2 = screen[f0], screen[f1], screen[f2]
    xs = torch.stack([p0[:, 0], p1[:, 0], p2[:, 0]], 1)
    ys = torch.stack([p0[:, 1], p1[:, 1], p2[:, 1]], 1)
    bb_min_x, bb_max_x = xs.amin(1), xs.amax(1)
    bb_min_y, bb_max_y = ys.amin(1), ys.amax(1)
    ok = ((p0[:, 2] > 0) & (p1[:, 2] > 0) & (p2[:, 2] > 0)
          & (bb_max_x >= 0) & (bb_min_x <= W - 1)
          & (bb_max_y >= 0) & (bb_min_y <= H - 1))
    rec = torch.cat([p0[:, :2], p1[:, :2], p2[:, :2], p0[:, 2:], p1[:, 2:],
                     p2[:, 2:]], dim=1).contiguous()
    return rec, cell_bins(bb_min_x, bb_min_y, bb_max_x, bb_max_y, ok, H, W,
                          mesh_cell_size(footprint))


def rasterize_mesh(cam: Camera, verts: torch.Tensor, faces: torch.Tensor,
                   footprint: int = 8) -> Fragments:
    """Nearest-face fragments (H, W) of the triangle mesh (verts (V, 3)
    world, faces (F, 3)).  Non-differentiable.

    footprint picks the cell size (``mesh_cell_size``), the expected bound
    on a triangle's projected bbox.  A wider triangle is binned into every
    cell it covers, where JAX keeps only its first 2x2 cells and leaves
    holes; so no triangle is dropped at any size.  Posed templates have
    such triangles: skinning stretches faces wherever the LBS weights mix
    joints that move apart."""
    with torch.no_grad():
        rec, b = mesh_bins(cam, verts, faces, footprint)
        zbuf, face, bary = MK.mesh_fragments(
            rec, b.entries, b.cell_ids, b.starts, b.counts, b.cs, b.ncx,
            cam.H, cam.W)
    return Fragments(pix_to_face=face, bary=bary, zbuf=zbuf)
