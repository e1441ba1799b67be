"""SMPL body model pieces the training slice needs (torch port of
``selfreconcode_tpu/models/smpl.py``): the deterministic toy body, the shape
blend, the forward kinematics and the canonical A-pose.  The pickle loader
and its schema validator are not ported yet."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.math import batch_rodrigues, make_homo

NUM_JOINTS = 24
NUM_BETAS = 10

# SMPL kinematic tree (kintree_table row 0 of the standard model).
SMPL_PARENTS = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
     20, 21], dtype=np.int32)


@dataclass(frozen=True)
class SMPLModel:
    """Host-side constants (numpy); functions move them to the inputs'
    device."""
    v_template: np.ndarray     # (V, 3)
    shapedirs: np.ndarray      # (num_betas, V*3)
    posedirs: np.ndarray       # (207, V*3)
    j_regressor: np.ndarray    # (V, 24)
    weights: np.ndarray        # (V, 24)
    faces: np.ndarray          # (F, 3) int32
    parents: np.ndarray        # (24,) int32


def toy_smpl_model(n_verts: int = 800, seed: int = 0) -> SMPLModel:
    """Deterministic synthetic stand-in with SMPL's tensor shapes (except
    the vertex count); identical numbers to the JAX package's toy body."""
    rng = np.random.default_rng(seed)
    joints = np.zeros((NUM_JOINTS, 3), np.float32)
    joints[1] = [0.1, -0.05, 0]; joints[2] = [-0.1, -0.05, 0]
    joints[3] = [0, 0.1, 0]
    joints[4] = [0.12, -0.45, 0]; joints[5] = [-0.12, -0.45, 0]
    joints[6] = [0, 0.22, 0]
    joints[7] = [0.13, -0.85, 0]; joints[8] = [-0.13, -0.85, 0]
    joints[9] = [0, 0.30, 0]
    joints[10] = [0.14, -0.95, 0.1]; joints[11] = [-0.14, -0.95, 0.1]
    joints[12] = [0, 0.45, 0]
    joints[13] = [0.08, 0.40, 0]; joints[14] = [-0.08, 0.40, 0]
    joints[15] = [0, 0.55, 0]
    joints[16] = [0.2, 0.40, 0]; joints[17] = [-0.2, 0.40, 0]
    joints[18] = [0.45, 0.40, 0]; joints[19] = [-0.45, 0.40, 0]
    joints[20] = [0.7, 0.40, 0]; joints[21] = [-0.7, 0.40, 0]
    joints[22] = [0.78, 0.40, 0]; joints[23] = [-0.78, 0.40, 0]
    base = rng.integers(0, NUM_JOINTS, n_verts)
    v_template = joints[base] + rng.normal(0, 0.05, (n_verts, 3)).astype(
        np.float32)
    d = np.linalg.norm(v_template[:, None, :] - joints[None, :, :], axis=-1)
    w = np.exp(-d / 0.05)
    weights = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    jr = np.exp(-d.T / 0.02)
    jr = jr / jr.sum(-1, keepdims=True)
    shapedirs = rng.normal(0, 0.01, (NUM_BETAS, n_verts * 3)).astype(
        np.float32)
    posedirs = rng.normal(0, 0.001, (207, n_verts * 3)).astype(np.float32)
    faces = rng.integers(0, n_verts, (2 * n_verts, 3)).astype(np.int32)
    return SMPLModel(v_template=v_template, shapedirs=shapedirs,
                     posedirs=posedirs,
                     j_regressor=jr.T.astype(np.float32), weights=weights,
                     faces=faces, parents=SMPL_PARENTS)


def _t(x, like: torch.Tensor):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def shaped_verts_and_joints(model: SMPLModel, beta: torch.Tensor):
    """beta (B, num_betas) -> (v_shaped (B, V, 3), joints (B, 24, 3))."""
    n_verts = model.v_template.shape[0]
    v_shaped = (beta @ _t(model.shapedirs, beta)).reshape(-1, n_verts, 3) \
        + _t(model.v_template, beta)
    joints = torch.einsum("bvc,vj->bjc", v_shaped, _t(model.j_regressor, beta))
    return v_shaped, joints


def global_rigid_transform(rot_mats, joints, parents):
    """FK: rot_mats (B,24,3,3), joints (B,24,3) -> (posed joints (B,24,3),
    A (B,24,4,4) with the rest joint location removed)."""
    B = rot_mats.shape[0]
    results = [make_homo(rot_mats[:, 0], joints[:, 0])]
    for i in range(1, len(parents)):
        j_rel = joints[:, i] - joints[:, parents[i]]
        results.append(results[parents[i]] @ make_homo(rot_mats[:, i], j_rel))
    results = torch.stack(results, dim=1)
    posed_joints = results[:, :, :3, 3]
    j_homo = torch.cat([joints, joints.new_zeros(B, len(parents), 1)], dim=-1)
    init_bone = torch.einsum("bjik,bjk->bji", results, j_homo)
    A = results.clone()
    A[:, :, :3, 3] = A[:, :, :3, 3] - init_bone[:, :, :3]
    return posed_joints, A


def smpl_forward(model: SMPLModel, beta: torch.Tensor, theta: torch.Tensor):
    """beta (B, nb), theta (B, 24, 3) axis-angle -> (verts (B,V,3),
    posed joints (B,24,3), Rs (B,24,3,3))."""
    B = beta.shape[0]
    n_verts = model.v_template.shape[0]
    v_shaped, joints = shaped_verts_and_joints(model, beta)
    Rs = batch_rodrigues(theta.reshape(-1, 3)).reshape(B, NUM_JOINTS, 3, 3)
    eye = torch.eye(3, dtype=beta.dtype, device=beta.device)
    pose_feature = (Rs[:, 1:] - eye).reshape(B, 207)
    v_posed = (pose_feature @ _t(model.posedirs, beta)).reshape(
        B, n_verts, 3) + v_shaped
    posed_joints, A = global_rigid_transform(Rs, joints, model.parents)
    T = torch.einsum("vj,bjik->bvik", _t(model.weights, beta), A)
    v_homo = torch.cat([v_posed, v_posed.new_ones(B, n_verts, 1)], dim=-1)
    verts = torch.einsum("bvik,bvk->bvi", T, v_homo)[..., :3]
    return verts, posed_joints, Rs


def smpl_tmp_apose(init_pose_type: int = 0) -> np.ndarray:
    """Canonical A-pose of the template space (24, 3)."""
    pose = np.zeros((24, 3))
    if init_pose_type == 0:
        pose[1] = [0, 0, 10.0 / 180.0 * np.pi]
        pose[2] = [0, 0, -10.0 / 180.0 * np.pi]
        pose[16] = [0, 0, -45.0 / 180.0 * np.pi]
        pose[17] = [0, 0, 45.0 / 180.0 * np.pi]
    elif init_pose_type == 1:
        pose[1] = [0, 0, 7.0 / 180.0 * np.pi]
        pose[2] = [0, 0, -7.0 / 180.0 * np.pi]
        pose[16] = [0, 0, -55.0 / 180.0 * np.pi]
        pose[17] = [0, 0, 55.0 / 180.0 * np.pi]
    else:
        raise ValueError(init_pose_type)
    return pose.astype(np.float32)
