"""Per-primitive 2x2 image-cell coverage entries (torch port of
``selfreconcode_tpu/ops/binning.py::bbox_cell_entries``)."""
from __future__ import annotations

import torch


def bbox_cell_entries(bb_min_x, bb_min_y, bb_max_x, bb_max_y, valid,
                      cell_size: int, ncx: int, ncy: int):
    """Primitive bboxes are <= cell_size, so each touches at most a 2x2 cell
    block.  Returns (cell_ids (4M,), entry_valid (4M,)); entry e covers
    primitive e mod M."""
    cx0 = torch.floor(bb_min_x / cell_size).to(torch.int32)
    cy0 = torch.floor(bb_min_y / cell_size).to(torch.int32)
    cx1 = torch.floor(bb_max_x / cell_size).to(torch.int32)
    cy1 = torch.floor(bb_max_y / cell_size).to(torch.int32)
    cells, valids = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            cx = cx0 if dx == 0 else cx1
            cy = cy0 if dy == 0 else cy1
            ok = valid & (cx >= 0) & (cx < ncx) & (cy >= 0) & (cy < ncy)
            if dx:
                ok = ok & (cx1 > cx0)
            if dy:
                ok = ok & (cy1 > cy0)
            cells.append(torch.where(ok, cy * ncx + cx, torch.zeros_like(cx)))
            valids.append(ok)
    return torch.cat(cells), torch.cat(valids)
