"""Composite deformation: translator MLP then LBS skinning (frozen copy of the port's
``selfreconcode_tpu_torch/models/deformer.py``); the skinner's weight lookup uses
the translated points."""
from __future__ import annotations

import torch

from .skinner import Skinner, frame_rows, skinner_apply
from .translator import TranslatorNet


def deformer_apply(translator: TranslatorNet, skinner: Skinner, pts,
                   batch_inds, dcond, poses, trans, ratio=None):
    """pts (N,3), batch_inds (N,), dcond (B,C), poses (B,24,3), trans (B,3)
    -> (deformed (N,3), translator offset (N,3))."""
    translated, offset = translator(pts, frame_rows(dcond, batch_inds), ratio)
    return skinner_apply(skinner, translated, batch_inds, poses, trans), offset


def point_jacobian(fn, pts: torch.Tensor, create_graph: bool = True):
    """Per-point 3x3 Jacobian of a pointwise map fn: (N,3) -> (N,3), by three
    reverse-mode passes; (jac (N,3,3) with jac[:, r, c] = d out_r / d p_c,
    out (N,3)).  Gradients keep flowing to `pts` when it carries a graph."""
    if not pts.requires_grad:
        pts = pts.detach().requires_grad_(True)
    with torch.enable_grad():
        out = fn(pts)
        rows = [torch.autograd.grad(out[:, r].sum(), pts,
                                    create_graph=create_graph,
                                    retain_graph=True)[0]
                for r in range(3)]
    return torch.stack(rows, dim=1), out


def deformer_jacobian(translator: TranslatorNet, skinner: Skinner, pts,
                      batch_inds, dcond, poses, trans, ratio=None,
                      create_graph: bool = True):
    """(jac (N,3,3), deformed (N,3)); differentiable again with
    create_graph (the normal loss differentiates through it)."""
    return point_jacobian(
        lambda q: deformer_apply(translator, skinner, q, batch_inds, dcond,
                                 poses, trans, ratio)[0],
        pts, create_graph)
