"""Non-rigid deformation MLP (frozen copy of the port's
``selfreconcode_tpu_torch/models/translator.py``): 5 linear layers
[PE(p)+cond, 512, 512, 512, 512, 3], ReLU; the initial weights come from
``benchmark/weights.py``."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .pe import embed_dim, positional_encoding


class TranslatorNet(nn.Module):
    def __init__(self, cond_size: int = 128, multires: int = 6,
                 hidden: Tuple[int, ...] = (512, 512, 512, 512),
                 d_out: int = 3):
        super().__init__()
        self.cond_size = cond_size
        self.multires = multires
        in_ch = embed_dim(multires, 3) if multires > 0 else 3
        self.dims = [in_ch + cond_size] + list(hidden) + [d_out]
        self.n_lin = len(self.dims) - 1
        for l in range(self.n_lin):
            setattr(self, f"lin{l}", nn.Linear(self.dims[l], self.dims[l + 1]))

    def offset(self, pts, cond, ratio=None):
        """pts (..., 3), cond broadcastable to (..., cond_size) -> (..., 3)."""
        emb = positional_encoding(pts, self.multires, ratio)
        cond = cond.expand(emb.shape[:-1] + (self.cond_size,))
        x = torch.cat([emb, cond], dim=-1)
        for l in range(self.n_lin):
            x = getattr(self, f"lin{l}")(x)
            if l < self.n_lin - 1:
                x = torch.relu(x)
        return x

    def forward(self, pts, cond, ratio=None):
        """Returns (deformed points p + offset, offset)."""
        off = self.offset(pts, cond, ratio)
        return pts + off, off
