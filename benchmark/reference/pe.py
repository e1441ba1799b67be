"""Annealed NeRF positional encoding (frozen copy of the port's
``selfreconcode_tpu_torch/utils/pe.py``)."""
from __future__ import annotations

import math

import torch


def embed_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def annealing_band_weights(multires: int, ratio, device=None) -> torch.Tensor:
    """Per-band window w_k = (1 - cos(pi * clip(ratio*multires - k, 0, 1)))/2."""
    alpha = float(ratio) * multires
    ks = torch.arange(multires, dtype=torch.float32, device=device)
    x = torch.clamp(alpha - ks, 0.0, 1.0)
    return (1.0 - torch.cos(math.pi * x)) / 2.0


def positional_encoding(x: torch.Tensor, multires: int,
                        ratio=None) -> torch.Tensor:
    """x (..., D) -> (..., D*(1+2*multires)): [x, sin(2^0 x), cos(2^0 x), ...],
    each band scaled by its annealing weight when ratio is given."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]                  # (..., L, D)
    sin, cos = torch.sin(xf), torch.cos(xf)
    if ratio is not None:
        w = annealing_band_weights(multires, ratio, x.device)[:, None]
        sin, cos = sin * w, cos * w
    feats = torch.stack([sin, cos], dim=-2)                # (..., L, 2, D)
    feats = feats.reshape(x.shape[:-1] + (2 * multires * x.shape[-1],))
    return torch.cat([x, feats], dim=-1)
