"""IDR-style colour network (frozen copy of the port's
``selfreconcode_tpu_torch/models/render.py``): input [points, PE(view), normal,
feature], 4x512 ReLU, tanh output in [-1, 1], weight norm.  The normal
is not encoded (config.conf's multires_n = 0)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .pe import embed_dim, positional_encoding
from .layers import WNLinear


class RenderNet(nn.Module):
    def __init__(self, feature_size: int = 256, d_in: int = 9, d_out: int = 3,
                 hidden: Tuple[int, ...] = (512, 512, 512, 512),
                 multires_v: int = 4):
        super().__init__()
        self.multires_v = multires_v
        d = d_in + feature_size
        if multires_v > 0:
            d += embed_dim(multires_v, 3) - 3
        self.dims = [d] + list(hidden) + [d_out]
        self.n_lin = len(self.dims) - 1
        for l in range(self.n_lin):
            setattr(self, f"lin{l}", WNLinear(self.dims[l], self.dims[l + 1]))

    def forward(self, points, normals, view_dirs, feature_vectors, ratio=None):
        """All (..., C) -> colours (..., 3) in [-1, 1]."""
        if self.multires_v > 0:
            view_dirs = positional_encoding(view_dirs, self.multires_v, ratio)
        x = torch.cat([points, view_dirs, normals, feature_vectors], dim=-1)
        for l in range(self.n_lin):
            x = getattr(self, f"lin{l}")(x)
            if l < self.n_lin - 1:
                x = torch.relu(x)
        return torch.tanh(x)
