"""Watertight synthetic SMPL stand-in at real fidelity (frozen copy of the port's
``selfreconcode_tpu_torch/models/synthetic_body.py``).

`toy_smpl_model` (smpl.py) has random non-watertight faces: fine for shape
tests, degenerate for anything that consumes geometry (IGR normal fits, mask
rendering, acceptance runs).  This module builds a watertight, manifold,
consistently oriented body mesh with exactly the requested vertex count
(default 6890 = real SMPL), plus smooth skinning weights, an exact joint
regressor and smooth blend-shape bases: a stand-in faithful to the real
`*_smpl_with_cocoplus_reg.pkl` schema (reference smpl_pytorch/SMPL.py:40-75)
in every property the pipeline relies on.

Construction: union-of-capsules SDF over the toy skeleton's bones, meshed by
the port's ``ops.marching_cubes`` on the CPU (the JAX package's numbering;
the 0.18 m margin keeps the surface off the sweep box, so no +boundary
crossing arises), then longest-edge 2-4 splits up to the exact target vertex
count (manifold-preserving).  Deterministic end to end, and the same arrays
as the JAX package's body.

`save_smpl_pickle` writes the exact on-disk schema the reference loader
consumes ((V,3,B) shapedirs, scipy-sparse J_regressor, uint32 kintree_table
with the 4294967295 root sentinel, cocoplus_regressor), so the real-asset
path `load_smpl_pickle` runs without the non-redistributable SMPL download.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .smpl import NUM_BETAS, NUM_JOINTS, SMPL_PARENTS, SMPLModel

# (child_joint, radius): bone = segment parent(child) -> child.  Torso and
# head thick, limbs thin: the proportions only need to be body-like.
_BONE_RADIUS = {
    1: 0.095, 2: 0.095,          # pelvis -> hips
    3: 0.115,                    # spine1
    4: 0.062, 5: 0.062,          # thighs
    6: 0.115,                    # spine2
    7: 0.048, 8: 0.048,          # calves
    9: 0.110,                    # chest
    10: 0.035, 11: 0.035,        # feet
    12: 0.045,                   # neck
    13: 0.075, 14: 0.075,        # collars
    15: 0.080,                   # head
    16: 0.055, 17: 0.055,        # shoulders
    18: 0.042, 19: 0.042,        # upper arms
    20: 0.036, 21: 0.036,        # forearms
    22: 0.030, 23: 0.030,        # hands
}


def _skeleton_joints() -> np.ndarray:
    """The toy humanoid skeleton (as in smpl.toy_smpl_model), y-up T-pose."""
    j = np.zeros((NUM_JOINTS, 3), np.float32)
    j[1] = [0.1, -0.05, 0]; j[2] = [-0.1, -0.05, 0]
    j[3] = [0, 0.1, 0]
    j[4] = [0.12, -0.45, 0]; j[5] = [-0.12, -0.45, 0]
    j[6] = [0, 0.22, 0]
    j[7] = [0.13, -0.85, 0]; j[8] = [-0.13, -0.85, 0]
    j[9] = [0, 0.30, 0]
    j[10] = [0.14, -0.95, 0.1]; j[11] = [-0.14, -0.95, 0.1]
    j[12] = [0, 0.45, 0]
    j[13] = [0.08, 0.40, 0]; j[14] = [-0.08, 0.40, 0]
    j[15] = [0, 0.55, 0]
    j[16] = [0.2, 0.40, 0]; j[17] = [-0.2, 0.40, 0]
    j[18] = [0.45, 0.40, 0]; j[19] = [-0.45, 0.40, 0]
    j[20] = [0.7, 0.40, 0]; j[21] = [-0.7, 0.40, 0]
    j[22] = [0.78, 0.40, 0]; j[23] = [-0.78, 0.40, 0]
    return j


def _segment_dist(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,3) points vs segment a->b: distance to the segment."""
    ab = b - a
    t = np.clip(((p - a) @ ab) / max(float(ab @ ab), 1e-12), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[:, None] * ab), axis=-1)


def _body_sdf(p: np.ndarray, joints: np.ndarray) -> np.ndarray:
    """Union-of-capsules SDF (negative inside)."""
    d = np.full(p.shape[0], np.inf, np.float32)
    for c, r in _BONE_RADIUS.items():
        a, b = joints[SMPL_PARENTS[c]], joints[c]
        d = np.minimum(d, _segment_dist(p, a, b) - r)
    # head: sphere on top of the head joint
    d = np.minimum(d, np.linalg.norm(p - (joints[15] + [0, 0.07, 0]),
                                     axis=-1) - 0.09)
    return d.astype(np.float32)


def _mesh_body(joints: np.ndarray, res: int):
    """Marching cubes of the capsule body on the CPU."""
    from .marching_cubes import marching_cubes

    margin = 0.18
    b_min = joints.min(0) - margin
    b_max = joints.max(0) + margin
    ext = b_max - b_min
    # per-axis odd resolutions proportional to extent (cubic-ish voxels)
    dims = tuple(int(2 * round(res * e / ext.max() / 2) + 1) for e in ext)
    xs = [np.linspace(b_min[k], b_max[k], dims[k], dtype=np.float32)
          for k in range(3)]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    vol = _body_sdf(pts, joints).reshape(dims)
    spacing = np.asarray([(b_max[k] - b_min[k]) / (dims[k] - 1)
                          for k in range(3)], np.float32)
    mc = marching_cubes(torch.from_numpy(vol), torch.from_numpy(b_min),
                        torch.from_numpy(spacing), 0.0)
    assert mc.n_boundary == 0
    return mc.verts.numpy().astype(np.float32), mc.faces.numpy().astype(
        np.int64)


def _split_longest_edges(verts: np.ndarray, faces: np.ndarray, target_nv: int):
    """Longest-edge 2-4 splits until exactly target_nv vertices.

    Each split of an interior manifold edge (a,b) with incident faces
    (a,b,c), (b,a,d) adds one midpoint vertex and replaces the two faces with
    four: watertightness and orientation are preserved.  Edges are split in
    batches (an independent set per round, longest first, ties in stable
    order) so rounds stay few.
    """
    verts = list(verts)
    faces = np.asarray(faces, np.int64)
    while len(verts) < target_nv:
        need = target_nv - len(verts)
        # undirected edge -> the (up to 2) incident face rows
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
        frow = np.tile(np.arange(len(faces)), 3)
        key = (np.minimum(e[:, 0], e[:, 1]) << 32) | np.maximum(e[:, 0],
                                                                e[:, 1])
        order = np.argsort(key, kind="stable")
        ks, es, fr = key[order], e[order], frow[order]
        first = np.r_[True, ks[1:] != ks[:-1]]
        starts = np.flatnonzero(first)
        counts = np.diff(np.r_[starts, len(ks)])
        # manifold interior edges only (exactly 2 incident faces)
        ok = counts == 2
        va = np.array(verts)
        elen = np.linalg.norm(va[es[starts][:, 0]] - va[es[starts][:, 1]],
                              axis=-1)
        cand = np.flatnonzero(ok)[np.argsort(-elen[ok], kind="stable")]
        used_face = np.zeros(len(faces), bool)
        new_faces = []
        n_split = 0
        for ci in cand:
            if n_split >= need:
                break
            s = starts[ci]
            f1, f2 = fr[s], fr[s + 1]
            if used_face[f1] or used_face[f2]:
                continue
            a, b = es[s]
            used_face[f1] = used_face[f2] = True
            m = len(verts)
            verts.append(0.5 * (va[a] + va[b]))
            for f in (f1, f2):
                tri = faces[f]
                # rotate so the split edge is (tri[0], tri[1]) in face order
                for r in range(3):
                    t = np.roll(tri, -r)
                    if {t[0], t[1]} == {a, b}:
                        tri = t
                        break
                new_faces.append([tri[0], m, tri[2]])
                new_faces.append([m, tri[1], tri[2]])
            n_split += 1
        assert n_split > 0, "no splittable edges (non-manifold input?)"
        faces = np.concatenate([faces[~used_face],
                                np.asarray(new_faces, np.int64)])
    return np.asarray(verts, np.float32), faces.astype(np.int32)


def _joint_regressor(verts: np.ndarray, joints: np.ndarray) -> np.ndarray:
    """(V,24) regressor with jr.T @ verts == joints exactly at beta=0.

    Per joint: the minimum-norm solution of the affine system
    [V_k^T; 1] u = [j; 1] over the K nearest vertices (4 equations, K >= 16
    unknowns: exactly solvable).
    """
    V = len(verts)
    K = 24
    jr = np.zeros((V, NUM_JOINTS), np.float64)
    for j in range(NUM_JOINTS):
        d = np.linalg.norm(verts - joints[j], axis=-1)
        nn = np.argsort(d)[:K]
        A = np.concatenate([verts[nn].T, np.ones((1, K))])  # (4,K)
        rhs = np.concatenate([joints[j], [1.0]])
        u, *_ = np.linalg.lstsq(A, rhs, rcond=None)  # min-norm exact solution
        jr[nn, j] = u
    return jr.astype(np.float32)


def _skinning_weights(verts: np.ndarray, joints: np.ndarray) -> np.ndarray:
    """Smooth (V,24) weights from capsule-surface distance, softmax over
    bones."""
    logits = np.full((len(verts), NUM_JOINTS), -np.inf, np.float64)
    tau = 0.04
    for c, r in _BONE_RADIUS.items():
        a, b = joints[SMPL_PARENTS[c]], joints[c]
        d = _segment_dist(verts, a, b) - r
        logits[:, c] = np.maximum(logits[:, c], -d / tau)
    logits[:, 15] = np.maximum(
        logits[:, 15],
        -(np.linalg.norm(verts - (joints[15] + [0, 0.07, 0]), axis=-1)
          - 0.09) / tau)
    logits[:, 0] = logits[:, [1, 2, 3]].max(-1) - 0.5  # root shares the pelvis
    w = np.exp(logits - logits.max(-1, keepdims=True))
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _smooth_basis(verts: np.ndarray, n: int, scale: float,
                  seed: int) -> np.ndarray:
    """(n, V*3) smooth low-frequency displacement bases (sines of random
    linear forms of position): the smoothness real blend shapes have."""
    rng = np.random.default_rng(seed)
    V = len(verts)
    out = np.zeros((n, V, 3), np.float32)
    for b in range(n):
        freq = rng.normal(0, 3.0, (3, 3))
        phase = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.normal(0, scale, 3)
        out[b] = np.sin(verts @ freq.T + phase) * amp
    # basis 0: global scale about the centroid (the dominant real beta-0 mode)
    if n > 0:
        out[0] = scale * 5.0 * (verts - verts.mean(0))
    return out.reshape(n, V * 3)


@functools.lru_cache(maxsize=4)
def synthetic_body_model(n_verts: int = 6890, res: int = 72,
                         seed: int = 0) -> SMPLModel:
    """Watertight SMPL-schema body model with exactly n_verts vertices.

    res sets the marching-cubes base mesh density; it must give fewer than
    n_verts vertices (the edge splits only add).  The default (res=72, ~5.3k
    base vertices) targets the real SMPL count 6890.  Cached: callers share
    the returned arrays and must not write to them.
    """
    joints = _skeleton_joints()
    verts, faces = _mesh_body(joints, res)
    assert len(verts) < n_verts, (
        f"base mesh already has {len(verts)} >= {n_verts} verts; lower res")
    verts, faces = _split_longest_edges(verts, faces, n_verts)
    return SMPLModel(
        v_template=verts,
        shapedirs=_smooth_basis(verts, NUM_BETAS, 0.004, seed + 1),
        posedirs=_smooth_basis(verts, 207, 3e-4, seed + 2),
        j_regressor=_joint_regressor(verts, joints),
        weights=_skinning_weights(verts, joints),
        faces=np.asarray(faces, np.int32),
        parents=SMPL_PARENTS)


def save_smpl_pickle(model: SMPLModel, path: str) -> None:
    """Write `model` in the exact `*_smpl_with_cocoplus_reg.pkl` schema.

    Layouts per the reference loader (smpl_pytorch/SMPL.py:40-75): shapedirs
    (V,3,B), posedirs (V,3,207), J_regressor scipy-sparse (V,24) (the loader
    densifies), weights (V,24), kintree_table uint32 (2,24) with the
    4294967295 root-parent sentinel, faces 'f', and a cocoplus_regressor.
    """
    import pickle
    import scipy.sparse as sp

    V = model.v_template.shape[0]
    B = model.shapedirs.shape[0]
    shapedirs = np.asarray(model.shapedirs).T.reshape(V, 3, B)
    posedirs = np.asarray(model.posedirs).T.reshape(V, 3, 207)
    kintree = np.zeros((2, NUM_JOINTS), np.uint32)
    kintree[0] = model.parents.astype(np.uint32)
    kintree[0, 0] = np.uint32(4294967295)
    kintree[1] = np.arange(NUM_JOINTS, dtype=np.uint32)
    data = {
        "v_template": np.asarray(model.v_template, np.float64),
        "shapedirs": shapedirs.astype(np.float64),
        "posedirs": posedirs.astype(np.float64),
        "J_regressor": sp.csc_matrix(np.asarray(model.j_regressor,
                                                np.float64)),
        "weights": np.asarray(model.weights, np.float64),
        "kintree_table": kintree,
        "f": np.asarray(model.faces, np.uint32),
        "cocoplus_regressor": np.zeros((V, 19), np.float64),
    }
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)
