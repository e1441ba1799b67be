"""Differentiable trilinear lookup in a corner-packed table (frozen copy of the port's
``selfreconcode_tpu_torch/ops/trilinear.py::trilinear_sample_packed2d``).

Plain gathers and lerps, not ``F.grid_sample``: the normal loss
differentiates twice through the deformer Jacobian, and this form is
differentiable to any order.  Semantics: grid_sample with border padding and
align_corners=False.
"""
from __future__ import annotations

import torch


def pack_corners(volume: torch.Tensor) -> torch.Tensor:
    """(D, H, W, C) -> (D*H*W, 8*C): row (z,y,x) holds the 8 cell corners
    [(z+dz, y+dy, x+dx) for dz,dy,dx in {0,1}^3], border-clamped."""
    D, H, W, C = volume.shape
    dev = volume.device

    def shift(dz, dy, dx):
        z = torch.clamp(torch.arange(D, device=dev) + dz, max=D - 1)
        y = torch.clamp(torch.arange(H, device=dev) + dy, max=H - 1)
        x = torch.clamp(torch.arange(W, device=dev) + dx, max=W - 1)
        return volume[z][:, y][:, :, x]

    corners = [shift(dz, dy, dx)
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(corners, dim=3).reshape(D * H * W, 8 * C)


def trilinear_sample_packed2d(table: torch.Tensor, dims, coords: torch.Tensor,
                              channels: int = 24) -> torch.Tensor:
    """table (D*H*W, 8*C) from pack_corners; dims (D, H, W); coords (N, 3) in
    [-1, 1] ordered (x, y, z) -> (N, C)."""
    D, H, W = dims
    C = channels
    x = ((coords[:, 0] + 1.0) * W - 1.0) / 2.0
    y = ((coords[:, 1] + 1.0) * H - 1.0) / 2.0
    z = ((coords[:, 2] + 1.0) * D - 1.0) / 2.0
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    tx, ty, tz = x - x0, y - y0, z - z0
    x0i = torch.clamp(x0.long(), 0, W - 1)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    z0i = torch.clamp(z0.long(), 0, D - 1)
    # border padding: when the base corner clamps, its fraction clamps too
    tx = torch.clamp(x0 + tx - x0i, 0.0, 1.0)[:, None]
    ty = torch.clamp(y0 + ty - y0i, 0.0, 1.0)[:, None]
    tz = torch.clamp(z0 + tz - z0i, 0.0, 1.0)[:, None]
    rows = table[(z0i * H + y0i) * W + x0i].to(coords.dtype)  # (N, 8*C)
    out = 0.0
    k = 0
    for dz in (0, 1):
        wz = tz if dz else (1 - tz)
        for dy in (0, 1):
            wy = ty if dy else (1 - ty)
            for dx in (0, 1):
                wx = tx if dx else (1 - tx)
                out = out + (wz * wy * wx) * rows[:, k * C:(k + 1) * C]
                k += 1
    return out
