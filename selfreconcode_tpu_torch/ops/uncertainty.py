"""PointRend-style uncertainty point selection on regular grids (torch port
of ``selfreconcode_tpu/ops/uncertainty.py``; the reference's
MCAcc/utils.py:172-318).

The octree sweep (``ops/sparse_sdf.py``) selects voxels by sign boundary;
these are the reference's alternative selectors.  As in the JAX package,
every call returns exactly ``num_points`` rows and a validity mask: the
reference's ``_faster`` variants (a threshold, then a truncating top-k)
become a top-k of scores with the sub-threshold ones set to -inf, whose
rows come last and are marked invalid.  Coordinates are integer grid
positions, x fastest.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "calculate_uncertainty",
    "uncertain_points_grid2d",
    "uncertain_points_grid3d",
]


def calculate_uncertainty(logits: torch.Tensor,
                          classes: Optional[torch.Tensor] = None,
                          balance_value: float = 0.5) -> torch.Tensor:
    """-|logit - balance_value| (highest at the decision boundary).
    `logits` is (R, C, ...); class-agnostic when C == 1, else `classes`
    (R,) picks each row's channel."""
    if logits.shape[1] == 1:
        gt = logits
    else:
        idx = classes.long().reshape(-1, 1, *([1] * (logits.ndim - 2)))
        gt = torch.take_along_dim(logits, idx, dim=1)
    return -(gt - balance_value).abs()


def _topk_points(flat: torch.Tensor, num_points: int,
                 clip_min: Optional[float]) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(R, M) scores -> ((R, P) indices, (R, P) valid)."""
    scores = flat if clip_min is None else torch.where(
        flat >= clip_min, flat, torch.full_like(flat, -torch.inf))
    top, idx = torch.topk(scores, min(num_points, flat.shape[-1]), dim=-1)
    return idx, torch.isfinite(top)


def uncertain_points_grid2d(uncertainty_map: torch.Tensor, num_points: int,
                            clip_min: Optional[float] = None):
    """The `num_points` most uncertain positions of an (R, 1, H, W) map:
    (indices (R, P) int32 into the flattened H*W grid, coords (R, P, 2)
    int32 as (x, y), valid (R, P) bool)."""
    R = uncertainty_map.shape[0]
    H, W = uncertainty_map.shape[-2:]
    idx, valid = _topk_points(uncertainty_map.reshape(R, H * W), num_points,
                              clip_min)
    coords = torch.stack([idx % W, idx // W], dim=-1).int()
    return idx.int(), coords, valid


def uncertain_points_grid3d(uncertainty_map: torch.Tensor, num_points: int,
                            clip_min: Optional[float] = None):
    """3-D analogue for an (R, 1, D, H, W) map: coords (R, P, 3) as
    (x, y, z)."""
    R = uncertainty_map.shape[0]
    D, H, W = uncertainty_map.shape[-3:]
    idx, valid = _topk_points(uncertainty_map.reshape(R, D * H * W),
                              num_points, clip_min)
    coords = torch.stack([idx % W, idx % (H * W) // W, idx // (H * W)],
                         dim=-1).int()
    return idx.int(), coords, valid
