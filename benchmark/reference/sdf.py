"""Canonical SDF field, IDR-style (frozen copy of the port's
``selfreconcode_tpu_torch/models/sdf.py``).

8x512 softplus(beta=100) MLP, skip connection at layer 4 (concat the input,
divide by sqrt(2)), weight norm, annealed PE (multires 6); output [sdf (1),
feature (256)].  The initial weights come from ``benchmark/weights.py``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from .pe import embed_dim, positional_encoding
from .layers import WNLinear, softplus_beta


class SDFNet(nn.Module):
    def __init__(self, d_in: int = 3, d_out: int = 1, feature_size: int = 256,
                 hidden: Tuple[int, ...] = (512,) * 8,
                 skip_in: Tuple[int, ...] = (4,), multires: int = 6,
                 bias: float = 0.6, beta: float = 100.0):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.feature_size = feature_size
        self.skip_in = tuple(skip_in)
        self.multires = multires
        self.bias = bias
        self.beta = beta
        in_ch = embed_dim(multires, d_in) if multires > 0 else d_in
        self.dims = [in_ch] + list(hidden) + [d_out + feature_size]
        self.n_lin = len(self.dims) - 1
        for l in range(self.n_lin):
            out_dim = (self.dims[l + 1] - self.dims[0]
                       if l + 1 in self.skip_in else self.dims[l + 1])
            setattr(self, f"lin{l}", WNLinear(self.dims[l], out_dim))

    def forward(self, pts: torch.Tensor, ratio=None):
        """pts (..., 3) -> (sdf (...,), feature (..., feature_size))."""
        emb = positional_encoding(pts, self.multires, ratio)
        x = emb
        for l in range(self.n_lin):
            if l in self.skip_in:
                x = torch.cat([x, emb], dim=-1) / np.sqrt(2)
            x = getattr(self, f"lin{l}")(x)
            if l < self.n_lin - 1:
                x = softplus_beta(x, self.beta)
        return x[..., 0], x[..., self.d_out:]


def sdf_grad(net: SDFNet, pts: torch.Tensor, ratio=None):
    """Point gradient (..., 3) of the SDF by reverse mode, differentiable
    again (the eikonal and normal losses).  Gradients still flow to `pts`
    when it carries a graph."""
    return sdf_value_and_grad(net, pts, ratio)[1]


def sdf_value_and_grad(net: SDFNet, pts, ratio=None,
                       create_graph: bool = True):
    """(sdf (...), grad (..., 3)) from one forward pass."""
    if not pts.requires_grad:
        pts = pts.detach().requires_grad_(True)
    with torch.enable_grad():
        sdf, feat = net(pts, ratio)
        (g,) = torch.autograd.grad(sdf.sum(), pts, create_graph=create_graph)
    return sdf, g, feat
