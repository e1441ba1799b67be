"""Non-rigid deformation MLP (torch port of
``selfreconcode_tpu/models/translator.py``): 5 linear layers
[PE(p)+cond, 512, 512, 512, 512, 3], ReLU, last layer ~zero-init (std 1e-3)
so deformation starts as identity."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.pe import embed_dim, positional_encoding


class TranslatorNet(nn.Module):
    def __init__(self, cond_size: int = 128, multires: int = 6,
                 hidden: Tuple[int, ...] = (512, 512, 512, 512),
                 d_out: int = 3, seed: Optional[int] = 0):
        super().__init__()
        self.cond_size = cond_size
        self.multires = multires
        in_ch = embed_dim(multires, 3) if multires > 0 else 3
        self.dims = [in_ch + cond_size] + list(hidden) + [d_out]
        self.n_lin = len(self.dims) - 1
        for l in range(self.n_lin):
            setattr(self, f"lin{l}", nn.Linear(self.dims[l], self.dims[l + 1]))
        if seed is not None:
            self.reset_from(np.random.default_rng(seed))

    def reset_from(self, rng: np.random.Generator):
        """torch.nn.Linear's U(+-1/sqrt(in)) init; last layer N(0, 1e-3), zero
        bias (the JAX package's scheme)."""
        for l in range(self.n_lin):
            lin = getattr(self, f"lin{l}")
            out_dim, in_dim = lin.weight.shape
            if l == self.n_lin - 1:
                w = rng.normal(0.0, 1e-3, (out_dim, in_dim))
                b = np.zeros((out_dim,))
            else:
                bound = 1.0 / np.sqrt(in_dim)
                w = rng.uniform(-bound, bound, (out_dim, in_dim))
                b = rng.uniform(-bound, bound, (out_dim,))
            with torch.no_grad():
                lin.weight.copy_(torch.as_tensor(w.astype(np.float32)))
                lin.bias.copy_(torch.as_tensor(b.astype(np.float32)))

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
