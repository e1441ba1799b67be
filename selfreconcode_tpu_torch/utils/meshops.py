"""Mesh helpers (torch port of ``selfreconcode_tpu/utils/meshops.py``):
normals, the edge topology and the three mesh regularizers of the
inner pass (pytorch3d's uniform Laplacian, edge-length and normal-consistency
losses in the reference, model/network.py:655-670), and PLY export.

Meshes are exact-size: every vertex and face is real, so there are no
validity masks; the topology is rebuilt from the faces at each remesh.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import trace


def face_normals(verts: torch.Tensor, faces: torch.Tensor, eps: float = 1e-6):
    """Unit face normals (F, 3)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = torch.cross(v1 - v0, v2 - v0, dim=-1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(eps)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Sum of incident unit face normals, normalized (V, 3)."""
    fn = face_normals(verts, faces)
    vn = torch.zeros_like(verts)
    for c in range(3):
        vn = vn.index_add(0, faces[:, c].long(), fn)
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp_min(eps)


class EdgeTopology(NamedTuple):
    edges: torch.Tensor        # (E, 2) unique undirected edges
    face_pairs: torch.Tensor   # (E_int, 2) the two faces of each interior edge


def build_edge_topology(faces: torch.Tensor) -> EdgeTopology:
    """Unique undirected edges of (F, 3) faces, in the JAX package's order:
    sorted by (min vertex, max vertex), each in the orientation of its first
    occurrence among the faces' (0,1), then (1,2), then (2,0) edges.  An
    edge shared by exactly two faces is interior; face_pairs names its two
    faces in that order, for the interior edges only, in edge order.  Exact
    size (no capacity), on the faces' device; built once per remesh, so the
    step's losses index nothing by a mask."""
    f = faces.long()
    F = f.shape[0]
    # the three list-index copies, hi.max(), the nonzero, the end's copy,
    # the interior edges' selection
    trace.count("host_syncs", 7)
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    fid = torch.arange(F, device=f.device).repeat(3)
    lo, hi = e.amin(1), e.amax(1)
    key = lo * (int(hi.max()) + 1 if F else 1) + hi
    key_s, order = torch.sort(key, stable=True)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    starts = torch.nonzero(first).squeeze(1)
    counts = torch.diff(starts, append=starts.new_tensor([key_s.numel()]))
    fid_s = fid[order]
    s_int = starts[counts == 2]
    return EdgeTopology(edges=e[order][starts],
                        face_pairs=torch.stack([fid_s[s_int],
                                                fid_s[s_int + 1]], 1))


def uniform_laplacian_loss(verts: torch.Tensor, edges: torch.Tensor,
                           eps: float = 1e-12) -> torch.Tensor:
    """Mean over vertices of || mean of the neighbours - v || (a vertex on
    no edge counts with its neighbour mean 0, as in JAX)."""
    e0, e1 = edges[:, 0], edges[:, 1]
    acc = torch.zeros_like(verts).index_add(0, e0, verts[e1]).index_add(
        0, e1, verts[e0])
    ones = verts.new_ones(edges.shape[0])
    deg = verts.new_zeros(verts.shape[0]).index_add(0, e0, ones).index_add(
        0, e1, ones)
    lap = acc / deg.clamp_min(1.0)[:, None] - verts
    return torch.sqrt((lap * lap).sum(-1).clamp_min(eps)).mean()


def edge_length_loss(verts: torch.Tensor, edges: torch.Tensor,
                     target_length: float = 0.0) -> torch.Tensor:
    """Mean over unique edges of (|e| - target)^2."""
    d = verts[edges[:, 0]] - verts[edges[:, 1]]
    lens = torch.sqrt((d * d).sum(-1).clamp_min(1e-12))
    return ((lens - target_length) ** 2).mean()


def normal_consistency_loss(verts: torch.Tensor, faces: torch.Tensor,
                            topo: EdgeTopology) -> torch.Tensor:
    """Mean over interior edges of 1 - cos(n_f0, n_f1)."""
    fn = face_normals(verts, faces)
    ef = topo.face_pairs
    per_e = 1.0 - (fn[ef[:, 0]] * fn[ef[:, 1]]).sum(-1)
    return per_e.sum() / max(ef.shape[0], 1)


def write_mesh(path, verts, faces):
    """ASCII PLY (the JAX package's fallback format), written in bulk."""
    if isinstance(verts, torch.Tensor):
        verts = verts.detach().cpu().numpy()
    if isinstance(faces, torch.Tensor):
        faces = faces.detach().cpu().numpy()
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        np.savetxt(f, verts, fmt="%.9g")
        np.savetxt(f, np.column_stack([np.full(len(faces), 3), faces]),
                   fmt="%d")
