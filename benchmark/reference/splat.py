"""The soft splat silhouette in plain PyTorch, with autograd for its
gradient: mask = 1 - prod_k (1 - clip(w_k)), w = 1 - d^2 / r^2 for every
(splat, pixel) pair within r of the splat's centre, computed densely over a
box of pixels around each point.  No binning and no kernel: the port's
splat kernels (``csrc/splat.cu``) compute the same function over their cell
bins."""
from __future__ import annotations

import math

import torch

from .camera import Camera, transform_points_screen

W_MAX = 1.0 - 1e-5


def splat_mask(cam: Camera, points: torch.Tensor,
               radius_ndc: float) -> torch.Tensor:
    """Soft mask (H, W) of world points (n, 3); differentiable in the points
    and the camera through the pixel coordinates (the depth only decides
    which points are in front of the camera)."""
    H, W = cam.H, cam.W
    r = radius_ndc * W / 2.0
    screen = transform_points_screen(cam, points)
    col, row, z = screen[:, 0], screen[:, 1], screen[:, 2].detach()
    ok = ((z > 0.0) & (col + r >= 0) & (col - r <= W - 1)
          & (row + r >= 0) & (row - r <= H - 1))
    col, row = col[ok], row[ok]
    k = int(math.ceil(r)) + 1
    off = torch.arange(-k, k + 1, device=points.device)
    px = torch.floor(col.detach()).long()[:, None, None] + off[None, None, :]
    py = torch.floor(row.detach()).long()[:, None, None] + off[None, :, None]
    dc = col[:, None, None] - px.to(col.dtype)
    dr = row[:, None, None] - py.to(row.dtype)
    w = 1.0 - (dc * dc + dr * dr) / (r * r)
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (w > 0.0)
    lt = torch.log1p(-w.clamp(0.0, W_MAX))
    pix = (py * W + px).expand(inb.shape)[inb]
    acc = lt.new_zeros(H * W).index_add(0, pix, lt[inb])
    return (1.0 - torch.exp(acc)).reshape(H, W)
