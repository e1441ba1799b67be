"""Point sampling for the eikonal / IGR losses (frozen copy of the port's
``selfreconcode_tpu_torch/utils/sampling.py``).

The random numbers come from an explicit ``torch.Generator`` or are passed
in (``noise`` / ``scores``), so tests can feed the JAX function and this
one the same draws.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_points(pc_input: torch.Tensor, global_sigma: float,
                  local_sigma: float, ratio: int = 6,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Tuple[torch.Tensor, ...]] = None):
    """N local samples (Gaussian jitter around the inputs) plus N//ratio
    global samples (uniform in [-global_sigma, global_sigma]^D).

    noise: (normal (N, D),) or (normal (N, D), uniform (N//ratio, D)) in
    place of fresh draws."""
    n, d = pc_input.shape
    if noise is None:
        kw = dict(generator=generator, device=pc_input.device,
                  dtype=pc_input.dtype)
        noise = (torch.randn((n, d), **kw),)
        if ratio > 0:
            noise += (torch.rand((n // ratio, d), **kw),)
    local = pc_input + noise[0] * local_sigma
    if ratio > 0:
        glob = (noise[1] * 2.0 - 1.0) * global_sigma
        return torch.cat([local, glob], dim=0)
    return local


def subsample_mask_topk(valid: torch.Tensor, k: int, scores: torch.Tensor):
    """Pick up to k True entries of `valid` at random, given uniform
    `scores` of valid's shape.

    Returns (idx (k,) int64, sel_valid (k,) bool): scores, -1 where invalid,
    top-k."""
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    top, idx = torch.topk(scores, k)
    return idx, top >= 0.0
