"""What the splat forward and backward of one frame need, counted from the
algorithm's inputs (the splat centres in pixels, the radius in pixels and
the image size) and not from the port's bins: the yardstick of
``splat_roofline``.

For each point in front of the camera: the pixels of its square box of
half-width r (what an exact kernel must test), the in-radius pairs of the
forward (w > 0) and of the backward (0 < w < 1 - 1e-5), and the pixels some
splat covers.  Bytes: each point read once (and its gradient written once
by the backward), each covered pixel's mask or cotangent moved once.
"""
from __future__ import annotations

import math

import torch

from .peaks import (OPS_BWD_HIT, OPS_COT, OPS_EXP, OPS_LOG1P, OPS_PAIR,
                    least_seconds)

W_MAX = 1.0 - 1e-5


@torch.no_grad()
def frame_work(col, row, z, r: float, H: int, W: int, chunk: int = 1 << 16):
    """Counts for one frame's splats at pixel centres (col, row), depth z."""
    ok = ((z > 0.0) & (col + r >= 0) & (col - r <= W - 1)
          & (row + r >= 0) & (row - r <= H - 1))
    col, row = col[ok], row[ok]
    k = int(math.ceil(r)) + 1
    off = torch.arange(-k, k + 1, device=col.device)
    box = fwd = bwd = 0
    covered = torch.zeros(H * W, dtype=torch.bool, device=col.device)
    for c, rw in zip(torch.split(col, chunk), torch.split(row, chunk)):
        px = torch.floor(c).long()[:, None, None] + off[None, None, :]
        py = torch.floor(rw).long()[:, None, None] + off[None, :, None]
        dc, dr = c[:, None, None] - px, rw[:, None, None] - py
        inb = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        w = 1.0 - (dc * dc + dr * dr) / (r * r)
        box += int((inb & (dc.abs() <= r) & (dr.abs() <= r)).sum())
        hit = inb & (w > 0.0)
        fwd += int(hit.sum())
        bwd += int((hit & (w < W_MAX)).sum())
        covered[(py * W + px).expand(hit.shape)[hit]] = True
    return {"points": int(col.numel()), "box_pairs": box, "fwd_hits": fwd,
            "bwd_hits": bwd, "covered_px": int(covered.sum())}


def least_time(work: dict) -> float:
    """The least seconds the card needs for one frame's splat forward and
    backward."""
    px, n = work["covered_px"], work["points"]
    fwd = least_seconds(OPS_PAIR * work["box_pairs"]
                        + OPS_LOG1P * work["fwd_hits"] + OPS_EXP * px,
                        8 * n + 4 * px)
    bwd = least_seconds(OPS_PAIR * work["box_pairs"]
                        + OPS_BWD_HIT * work["bwd_hits"] + OPS_COT * px,
                        8 * n + 4 * px + 8 * n)
    return fwd + bwd
