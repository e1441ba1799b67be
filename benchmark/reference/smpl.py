"""SMPL body model (frozen copy of the port's ``selfreconcode_tpu_torch/models/smpl.py``): the
``*_smpl_with_cocoplus_reg.pkl`` loader with its schema validator, the
shape blend, the forward kinematics and the canonical A-pose."""
from __future__ import annotations

import pickle
from dataclasses import dataclass

import numpy as np
import torch

from .mathops import batch_rodrigues, make_homo

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


class SMPLSchemaError(ValueError):
    """A `*_smpl_with_cocoplus_reg.pkl` failed schema validation.

    Every message names the offending field, what was found, and what the
    standard asset (smpl_pytorch/SMPL.py:27-75) is expected to contain: the
    loader meets a real downloaded asset for the first time in a user's
    hands, so errors must be actionable, not shape-mismatch tracebacks deep
    in the FK code.
    """


def load_smpl_pickle(path: str) -> SMPLModel:
    """Load a `*_smpl_with_cocoplus_reg.pkl` (the asset the reference uses).

    Validates the full schema before building the model; raises
    SMPLSchemaError with an actionable message on any deviation.
    """
    with open(path, "rb") as f:
        model = pickle.load(f, encoding="latin1")

    def _fail(msg):
        raise SMPLSchemaError(f"{path}: {msg}")

    if not isinstance(model, dict):
        _fail(f"expected a pickled dict, got {type(model).__name__}; the "
              "asset is the HMR-style *_smpl_with_cocoplus_reg.pkl "
              "(reference README.md:28)")
    required = ("v_template", "shapedirs", "posedirs", "J_regressor",
                "weights", "kintree_table", "f")
    missing = [k for k in required if k not in model]
    if missing:
        _fail(f"missing required key(s) {missing}; present keys: "
              f"{sorted(model.keys())}")

    v_template = np.array(model["v_template"], dtype=np.float64)
    if v_template.ndim != 2 or v_template.shape[1] != 3 or \
            v_template.shape[0] < NUM_JOINTS:
        _fail(f"v_template must be (V,3) with V>={NUM_JOINTS}, got "
              f"{v_template.shape}")
    V = v_template.shape[0]

    shapedirs = np.array(model["shapedirs"], dtype=np.float64)
    num_betas = shapedirs.shape[-1]
    if shapedirs.size != V * 3 * num_betas or num_betas < 1:
        _fail(f"shapedirs must reshape to (V*3, num_betas)=(({V}*3), B), "
              f"got shape {shapedirs.shape}")
    shapedirs = shapedirs.reshape(-1, num_betas).T

    posedirs = np.array(model["posedirs"], dtype=np.float64)
    if posedirs.shape[-1] != 207 or posedirs.size != V * 3 * 207:
        _fail(f"posedirs must be (V,3,207) (pose-blend basis over the 23 "
              f"non-root joint rotations), got shape {posedirs.shape}")
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T

    raw_jr = model["J_regressor"]
    if hasattr(raw_jr, "todense"):  # scipy sparse (the real asset ships CSC)
        j_regressor = np.asarray(raw_jr.todense(), dtype=np.float64)
    else:
        j_regressor = np.array(raw_jr, dtype=np.float64)
    if j_regressor.shape == (NUM_JOINTS, V) and V != NUM_JOINTS:
        # plain-SMPL orientation; the cocoplus asset stores (V,24)
        j_regressor = j_regressor.T
    if j_regressor.shape != (V, NUM_JOINTS):
        _fail(f"J_regressor must be (V,{NUM_JOINTS})=({V},{NUM_JOINTS}) "
              f"(dense or scipy-sparse), got {j_regressor.shape}")

    weights = np.array(model["weights"], dtype=np.float64)
    if weights.shape != (V, NUM_JOINTS):
        _fail(f"weights (LBS skinning weights) must be (V,{NUM_JOINTS})="
              f"({V},{NUM_JOINTS}), got {weights.shape}")
    wsum = weights.sum(axis=1)
    if weights.min() < -1e-4 or abs(wsum - 1.0).max() > 1e-3:
        _fail(f"weights rows must be a convex combination over joints "
              f"(min {weights.min():.3g}, row-sum range "
              f"[{wsum.min():.4f},{wsum.max():.4f}]); this does not look "
              "like an LBS weight matrix")

    kintree = np.array(model["kintree_table"])
    if kintree.ndim != 2 or kintree.shape[1] != NUM_JOINTS:
        _fail(f"kintree_table must be (2,{NUM_JOINTS}), got {kintree.shape}")
    parents = kintree[0].astype(np.int64)
    parents[0] = 0  # root sentinel (4294967295 in the real asset)
    if (parents[1:] >= np.arange(1, NUM_JOINTS)).any() or parents.min() < 0:
        _fail(f"kintree_table row 0 must be topologically ordered parents "
              f"(parent[i] < i for i>=1; SMPL's tree satisfies this), got "
              f"{parents.tolist()} — the unrolled FK chain "
              "(global_rigid_transform) requires it")
    parents = parents.astype(np.int32)

    faces = np.array(model["f"], dtype=np.int64)
    if faces.ndim != 2 or faces.shape[1] != 3 or faces.size == 0:
        _fail(f"f (faces) must be a non-empty (F,3) int array, got shape "
              f"{faces.shape}")
    if faces.min() < 0 or faces.max() >= V:
        _fail(f"face indices out of range [0,{V}): min {faces.min()}, max "
              f"{faces.max()} — 1-based or truncated face table?")
    return SMPLModel(
        v_template=v_template.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        j_regressor=j_regressor.astype(np.float32),
        weights=weights.astype(np.float32),
        faces=faces.astype(np.int32), parents=parents)


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
