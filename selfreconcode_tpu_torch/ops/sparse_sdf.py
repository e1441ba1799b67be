"""Coarse-to-fine sparse SDF grid evaluation, the octree sweep (torch port of
``selfreconcode_tpu/ops/sparse_sdf.py``: ``sparse_sdf_grid`` and
``interp2x_boundary3d``).

Evaluate the SDF on a coarse grid, upsample 2x, re-query only the voxels
whose 3^3 neighbourhood straddles the iso level, and repeat; a re-queried
voxel whose sign flips against its interpolated estimate seeds a re-query of
its not-yet-exact 3^3 neighbourhood (the conflict loop).  Queries are
exact-size: every boundary voxel is evaluated (no per-level budget).
World mapping: world(idx) = b_min + (idx + 0.5) * spacing on the finest grid.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import trace


def grid_world_coords(res_full: Tuple[int, int, int], b_min, b_max,
                      device="cpu"):
    """(spacing (3,), origin (3,)) float32 for the finest grid."""
    trace.count("host_syncs", 3)     # the three copies below
    b_min = torch.tensor(np.array(b_min, np.float32), device=device)
    b_max = torch.tensor(np.array(b_max, np.float32), device=device)
    r = torch.tensor(res_full, dtype=torch.float32, device=device)
    spacing = (b_max - b_min) / r
    return spacing, b_min + spacing / 2.0


def _upsample2(vol: torch.Tensor) -> torch.Tensor:
    """(n1,n2,n3) -> (2n1-1, 2n2-1, 2n3-1), exact at even indices, linear
    between."""
    for axis in range(3):
        a = vol.movedim(axis, 0)
        out = a.new_zeros((2 * a.shape[0] - 1,) + a.shape[1:])
        out[0::2] = a
        out[1::2] = (a[:-1] + a[1:]) / 2.0
        vol = out.movedim(0, axis)
    return vol


def _max3(v: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(v[None, None], 3, stride=1, padding=1)[0, 0]


def _dilate3(mask: torch.Tensor) -> torch.Tensor:
    return _max3(mask.to(torch.float32)) > 0


def _boundary_mask(vol, balance: float, dilate: int):
    """True where the 3^3 neighbourhood straddles `balance`, dilated."""
    mask = (_max3(vol) > balance) & (-_max3(-vol) <= balance)
    for _ in range(dilate):
        mask = _dilate3(mask)
    return mask


def sparse_sdf_grid(query_fn: Callable[[torch.Tensor], torch.Tensor],
                    resolutions: Sequence[Tuple[int, int, int]], b_min, b_max,
                    balance: float, dilate: int = 1,
                    conflict_iters: int = 4, device="cpu") -> torch.Tensor:
    """query_fn: (K, 3) world points -> (K,) values.  resolutions: per level
    (X, Y, Z), each 2n-1 of the previous.  Returns the finest volume."""
    res_full = tuple(int(v) for v in resolutions[-1])
    spacing, origin = grid_world_coords(res_full, b_min, b_max, device)
    r0 = tuple(int(v) for v in resolutions[0])
    strides = [(res_full[a] - 1) // (r0[a] - 1) for a in range(3)]
    axes = [torch.arange(r0[a], device=device) * strides[a] for a in range(3)]
    idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).float()
    vol = query_fn((origin + idx * spacing).reshape(-1, 3)).reshape(r0)
    queried = torch.ones(r0, dtype=torch.bool, device=device)

    for lvl in range(1, len(resolutions)):
        r = tuple(int(v) for v in resolutions[lvl])
        vol = _upsample2(vol)
        assert tuple(vol.shape) == r, (tuple(vol.shape), r)
        q_up = torch.zeros(r, dtype=torch.bool, device=device)
        q_up[0::2, 0::2, 0::2] = queried
        queried = q_up
        stride = (res_full[0] - 1) // (r[0] - 1)

        def query(mask):
            """Query the voxels of `mask`; returns their sign flips."""
            # the nonzero, the index_put of True and the flips' selection
            trace.count("host_syncs", 6)
            ijk = torch.nonzero(mask)
            vals = query_fn(origin + ijk.float() * stride * spacing)
            i, j, k = ijk.unbind(1)
            interp = vol[i, j, k]
            flips = (interp - balance) * (vals - balance) < 0
            vol[i, j, k] = vals
            queried[i, j, k] = True
            conf = torch.zeros(r, dtype=torch.bool, device=device)
            conf[i[flips], j[flips], k[flips]] = True
            return conf

        conf = query(_boundary_mask(vol, balance, dilate) & ~queried)
        for _ in range(conflict_iters):
            trace.count("host_syncs")
            if not bool(conf.any()):
                break
            conf = query(_dilate3(conf) & ~queried)
    return vol


def interp2x_boundary3d(vol: torch.Tensor, balance: float, dilate: int = 1):
    """2x upsample (exact at even indices, linear between) and the
    sign-boundary flags of the upsampled volume: (up (2n-1, ...),
    is_boundary).  The reference's optional CUDA path for the sweep
    (MCAcc/cuda/interp2x_boundary3d*.cu), which its shipped call sites
    leave off; differentiable in vol."""
    up = _upsample2(vol)
    return up, _boundary_mask(up, balance, dilate)
