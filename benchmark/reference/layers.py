"""Layer helpers (frozen copy of the port's ``selfreconcode_tpu_torch/models/layers.py``).

Weight normalization follows torch.nn.utils.weight_norm(dim=0): for a linear
map with weight W (out, in), W = g * v / ||v||_row with g (out, 1), stored as
``weight_v`` / ``weight_g`` like the reference checkpoints.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class WNLinear(nn.Module):
    """Weight-normalized linear layer (parameters weight_v, weight_g, bias)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.weight_g = nn.Parameter(torch.zeros(out_dim, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        norm = torch.linalg.norm(self.weight_v, dim=1, keepdim=True)
        w = self.weight_g * self.weight_v / norm.clamp_min(1e-12)
        return x @ w.T + self.bias


def softplus_beta(x, beta: float = 100.0):
    """torch.nn.Softplus(beta) semantics: identity where beta*x > 20."""
    return F.softplus(x, beta=beta, threshold=20.0)
