"""Loss terms of the per-subject optimization (frozen copy of the port's
``selfreconcode_tpu_torch/engine/losses.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .mathops import gm_robust


def masked_mean(x, valid, eps=1e-8):
    w = valid.to(x.dtype)
    return (x * w).sum() / w.sum().clamp_min(eps)


def iou_mask_loss(pred_masks, gt_masks):
    """1 - IoU per frame, averaged."""
    N = pred_masks.shape[0]
    p = pred_masks.reshape(N, -1)
    g = gt_masks.reshape(N, -1)
    inter = (p * g).sum(1)
    union = (p + g - p * g).abs().sum(1)
    return (1.0 - inter / union.clamp_min(1e-8)).mean()


def max_pool_mask(mask, radius_px: int):
    """(B,H,W) max-pool, kernel 2r+1, stride 1, same size (gt dilation)."""
    if radius_px <= 0:
        return mask
    return F.max_pool2d(mask[:, None], 2 * radius_px + 1, stride=1,
                        padding=radius_px)[:, 0]


def dct_prior_loss(dctnull, posed_joints_windows):
    """|DCTNull @ J(t)| averaged; dctnull (K', Nw), joints (B, Nw, 24, 3)."""
    B, Nw = posed_joints_windows.shape[:2]
    traj = posed_joints_windows.reshape(B, Nw, 72)
    return torch.einsum("kn,bnj->bkj", dctnull, traj).abs().mean()


def frame_counts(batch_inds, valid, num_frames: int):
    """Per frame, the number of valid rays (float)."""
    w = valid.to(torch.float32)
    return w.new_zeros(num_frames).index_add(0, batch_inds, w)


def _per_frame_mean(per_ray, batch_inds, valid, cnts):
    """Mean over frames (those with a valid ray) of each frame's mean.
    `cnts`: the per-frame counts of the valid rays (``frame_counts``) of
    every rank, when these rays are one rank's share; the result is then
    this share's part of the mean."""
    w = valid.to(per_ray.dtype)
    sums = per_ray.new_zeros(cnts.shape[0]).index_add(0, batch_inds,
                                                      per_ray * w)
    per_frame = sums / cnts.clamp_min(1e-8)
    return masked_mean(per_frame, cnts > 0)


def color_l1_loss(pred, gt, batch_inds, valid, cnts):
    """Per-ray L1 summed over channels, mean per frame, then mean."""
    return _per_frame_mean((gt - pred).abs().sum(-1), batch_inds, valid,
                           cnts)


def normal_loss(gt_normals_pulled, sdf_normals, weights, batch_inds, valid,
                cnts):
    """||J^T n_gt - n_sdf|| weighted, mean per frame, then mean."""
    per_ray = torch.linalg.norm(gt_normals_pulled - sdf_normals,
                                dim=-1) * weights
    return _per_frame_mean(per_ray, batch_inds, valid, cnts)


def def_consistency_loss(def_verts, lbs_only_verts, vert_valid, c: float):
    """GM(||D(v) - LBS(v)||^2) mean over template verts; (B,V,3) inputs."""
    off2 = ((def_verts - lbs_only_verts) ** 2).sum(-1)
    if c > 0:
        per = gm_robust(off2, c, square=True)
    else:
        per = torch.sqrt(off2.clamp_min(1e-12))
    # the weight is (1, V): the sum over frames is divided by V, as in JAX
    return masked_mean(per, vert_valid[None, :])


def sdf_anchor_loss(sdf_at_verts, vert_valid, shrink_radius: float):
    """|sdf(template verts) + shrink| mean."""
    return masked_mean((sdf_at_verts + shrink_radius).abs(), vert_valid)
