"""Image-cell coverage entries of primitive bboxes (torch port of
``selfreconcode_tpu/ops/binning.py::bbox_cell_entries``)."""
from __future__ import annotations

import torch

from ..utils import trace


def bbox_cell_entries(bb_min_x, bb_min_y, bb_max_x, bb_max_y, valid,
                      cell_size: int, ncx: int, ncy: int):
    """One entry per (primitive, image cell its bbox covers).

    Returns (cell ids (M,), entry ids (M,)), entry id = k * n + primitive
    for n primitives, so entry mod n is the primitive.  k is the JAX
    corner index 2*dy + dx of the cell's offset from the bbox's first cell,
    each offset capped at 1: a bbox of at most one cell (all that JAX bins;
    it drops cells beyond its 2x2 block) gets exactly JAX's entry ids, and a
    wider one gets every cell it covers."""
    n = bb_min_x.shape[0]
    cx0 = torch.floor(bb_min_x / cell_size).long()
    cy0 = torch.floor(bb_min_y / cell_size).long()
    cx1 = torch.floor(bb_max_x / cell_size).long()
    cy1 = torch.floor(bb_max_y / cell_size).long()
    ok = valid & (cx1 >= 0) & (cx0 < ncx) & (cy1 >= 0) & (cy0 < ncy)
    xa, ya = cx0.clamp(0, ncx - 1), cy0.clamp(0, ncy - 1)
    nx = cx1.clamp(0, ncx - 1) - xa + 1
    ny = cy1.clamp(0, ncy - 1) - ya + 1
    per = torch.where(ok, nx * ny, torch.zeros_like(nx))
    trace.count("host_syncs")
    total = int(per.sum())
    prim = torch.repeat_interleave(torch.arange(n, device=per.device), per,
                                   output_size=total)
    local = (torch.arange(total, device=per.device)
             - torch.repeat_interleave(torch.cumsum(per, 0) - per, per,
                                       output_size=total))
    x = xa[prim] + local % nx[prim]
    y = ya[prim] + local // nx[prim]
    k = (2 * (y - cy0[prim]).clamp(max=1) + (x - cx0[prim]).clamp(max=1))
    return y * ncx + x, k * n + prim
