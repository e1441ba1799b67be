"""SMPL-driven LBS skinning warp over a precomputed weight volume (torch port
of ``selfreconcode_tpu/models/skinner.py``).

The weight volume is built once per subject (kNN inverse-distance diffusion
of the SMPL vertex weights onto a grid, then neighbour-mean smoothing) and
stored corner-packed in float32; the per-point lookup is the differentiable
gather-and-lerp of ``ops/trilinear.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.trilinear import pack_corners, trilinear_sample_packed2d
from ..utils.math import batch_rodrigues, make_homo, rigid_inverse_homo
from .smpl import SMPLModel, shaped_verts_and_joints, smpl_forward


@dataclass
class Skinner:
    ws: torch.Tensor              # (D*H*W, 8*24) corner-packed weight table
    ws_dims: Tuple[int, int, int]  # (D, H, W)
    b_min: torch.Tensor           # (3,)
    b_max: torch.Tensor           # (3,)
    joints: torch.Tensor          # (24, 3) rest skeleton
    init_pose_inv: torch.Tensor   # (24, 4, 4) inverse A-pose transforms
    parents: Tuple[int, ...]


def fk_transforms(skinner: Skinner, poses: torch.Tensor):
    """poses (B,J,3) axis-angle -> (A (B,J,4,4) template->posed before
    +trans, FK results (B,J,4,4)).  One Rodrigues and one homogeneous build
    for all joints, then the chain joint by joint: each joint's transform is
    its parent's times its own, the same products in the same order as a
    chain that builds each joint's transform alone, so the same bits."""
    B, n = poses.shape[0], len(skinner.parents)
    Rs = batch_rodrigues(poses.reshape(-1, 3)).reshape(B, n, 3, 3)
    J = skinner.joints
    # each joint's offset from its parent (the root's from the origin)
    rel = torch.cat([J[:1], J[1:] - torch.stack([J[p] for p in
                                                 skinner.parents[1:]])])
    H = make_homo(Rs, rel.expand(B, n, 3))
    results = [H[:, 0]]
    for i in range(1, n):
        results.append(results[skinner.parents[i]] @ H[:, i])
    results = torch.stack(results, dim=1)
    A = torch.einsum("bjik,jkl->bjil", results, skinner.init_pose_inv)
    return A, results


def posed_skeleton(skinner: Skinner, poses: torch.Tensor) -> torch.Tensor:
    """FK joint positions (B, 24, 3), without +trans (as the reference)."""
    return fk_transforms(skinner, poses)[1][:, :, :3, 3]


def sample_skin_weights(skinner: Skinner, pts: torch.Tensor) -> torch.Tensor:
    """pts (N, 3) template coords -> (N, 24) LBS weights."""
    nps = 2.0 * (pts - skinner.b_min) / (skinner.b_max - skinner.b_min) - 1.0
    return trilinear_sample_packed2d(skinner.ws, skinner.ws_dims, nps)


def frame_rows(x: torch.Tensor, batch_inds: torch.Tensor) -> torch.Tensor:
    """x[batch_inds] for a per-frame table x (B, C), as a one-hot matmul.
    Same values; its backward is a GEMM, where the gather's backward is an
    index_put_ that serializes on the ~1e5 duplicate indices per frame (it
    took half the device time of a coarse step on an H100)."""
    onehot = torch.nn.functional.one_hot(batch_inds, x.shape[0]).to(x.dtype)
    return onehot @ x


def skinner_apply(skinner: Skinner, pts, batch_inds, poses, trans):
    """pts (N,3), batch_inds (N,) frame index, poses (B,24,3), trans (B,3)
    -> deformed (N,3)."""
    return skinner_apply_transforms(skinner, fk_transforms(skinner, poses)[0],
                                    pts, batch_inds, trans)


def skinner_apply_transforms(skinner: Skinner, A, pts, batch_inds, trans):
    """``skinner_apply`` from the poses' FK transforms A (B,24,4,4) of
    ``fk_transforms``, so that a caller skinning many point sets at the
    same poses runs the FK (and its host copies) once."""
    B = A.shape[0]
    w = sample_skin_weights(skinner, pts)                          # (N,24)
    onehot = torch.nn.functional.one_hot(batch_inds, B).to(pts.dtype)
    wb = (w[:, :, None] * onehot[:, None, :]).reshape(pts.shape[0], 24 * B)
    A16 = A.transpose(0, 1).reshape(24 * B, 16)
    T = (wb @ A16).reshape(-1, 4, 4)
    out = torch.einsum("nij,nj->ni", T[:, :3, :3], pts) + T[:, :3, 3]
    return out + onehot @ trans


def skinner_apply_shared(skinner: Skinner, pts, A, trans):
    """pts (V,3) shared by all B frames, skinned at the poses' FK
    transforms A (B,24,4,4) of ``fk_transforms`` -> (B,V,3)."""
    w = sample_skin_weights(skinner, pts)
    T = torch.einsum("vj,bjkl->bvkl", w, A)
    out = torch.einsum("bvij,vj->bvi", T[:, :, :3, :3], pts) + T[:, :, :3, 3]
    return out + trans[:, None, :]


# ---------------------------------------------------------------------------
# One-time weight-field construction
# ---------------------------------------------------------------------------

def smooth_weights(weights: torch.Tensor, times: int = 3) -> torch.Tensor:
    """Interior neighbour-mean relaxation with 0.7 mixing, renormalized;
    weights (D, H, W, C)."""
    w = weights
    for _ in range(times):
        mean = (w[2:, 1:-1, 1:-1] + w[:-2, 1:-1, 1:-1]
                + w[1:-1, 2:, 1:-1] + w[1:-1, :-2, 1:-1]
                + w[1:-1, 1:-1, 2:] + w[1:-1, 1:-1, :-2]) / 6.0
        interior = (w[1:-1, 1:-1, 1:-1] - mean) * 0.7 + mean
        w = w.clone()
        w[1:-1, 1:-1, 1:-1] = interior
        w = w / w.sum(-1, keepdim=True)
    return w


@torch.no_grad()
def compute_lbs_weight_field(b_min, b_max, resolution, smpl_verts, smpl_ws,
                             mean_neighbor: int = 30, smooth_times: int = 30,
                             chunk: int = 4096) -> torch.Tensor:
    """Diffuse per-vertex SMPL weights onto a (W, H, D) grid of voxel
    centres; returns (D, H, W, 24)."""
    W, H, D = resolution
    dev = smpl_verts.device
    b_min = torch.tensor(np.array(b_min, np.float32), device=dev).reshape(1, 3)
    b_max = torch.tensor(np.array(b_max, np.float32), device=dev).reshape(1, 3)
    res = torch.tensor([W, H, D], dtype=torch.float32, device=dev)
    zz, yy, xx = torch.meshgrid(torch.arange(D, device=dev),
                                torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
    coords = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3).float()
    coords = (coords / res + 0.5 / res) * (b_max - b_min) + b_min
    out = []
    for c in torch.split(coords, chunk):
        d = torch.linalg.norm(c[:, None, :] - smpl_verts[None, :, :], dim=-1)
        dk, idx = torch.topk(d, mean_neighbor, dim=1, largest=False)
        w = 1.0 / dk.clamp(1e-4, 1.0)
        w = w / w.sum(-1, keepdim=True)
        out.append(torch.einsum("nk,nkj->nj", w, smpl_ws[idx]))
    fws = torch.cat(out).reshape(D, H, W, smpl_ws.shape[-1])
    return smooth_weights(fws, smooth_times)


@torch.no_grad()
def build_skinner(model: SMPLModel, shape, init_pose: np.ndarray,
                  resolution=(129, 225, 65), b_min=None, b_max=None,
                  margin=(0.15, 0.15, 0.20), device="cpu"):
    """Returns (Skinner, A-pose template verts (V,3), faces (F,3) np.int32);
    the bbox is the A-pose verts +- margin unless given."""
    f32 = dict(dtype=torch.float32, device=device)
    shape_t = torch.as_tensor(np.asarray(shape), **f32).reshape(1, -1)
    pose_t = torch.as_tensor(np.asarray(init_pose), **f32).reshape(1, 24, 3)
    joints = shaped_verts_and_joints(model, shape_t)[1][0]
    verts = smpl_forward(model, shape_t, pose_t)[0][0]
    init_R = batch_rodrigues(pose_t.reshape(-1, 3)).reshape(24, 3, 3)
    Rs_acc, Ts_acc = [init_R[0]], [joints[0]]
    for i in range(1, 24):
        p = int(model.parents[i])
        Rs_acc.append(Rs_acc[p] @ init_R[i])
        Ts_acc.append(Rs_acc[p] @ (joints[i] - joints[p]) + Ts_acc[p])
    inv = rigid_inverse_homo(torch.stack(Rs_acc), torch.stack(Ts_acc))
    if b_min is None or b_max is None:
        m = np.asarray(margin, np.float32)
        v = verts.cpu().numpy()
        b_min, b_max = v.min(0) - m, v.max(0) + m
    ws = compute_lbs_weight_field(
        b_min, b_max, tuple(int(r) for r in resolution), verts,
        torch.as_tensor(model.weights, **f32))
    skinner = Skinner(
        ws=pack_corners(ws), ws_dims=tuple(int(v) for v in ws.shape[:3]),
        b_min=torch.as_tensor(np.asarray(b_min), **f32).reshape(3),
        b_max=torch.as_tensor(np.asarray(b_max), **f32).reshape(3),
        joints=joints, init_pose_inv=inv,
        parents=tuple(int(p) for p in model.parents))
    return skinner, verts, model.faces
