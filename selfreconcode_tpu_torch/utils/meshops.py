"""Mesh helpers (torch port of the parts of
``selfreconcode_tpu/utils/meshops.py`` the training and inference slices
use)."""
from __future__ import annotations

import numpy as np
import torch


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
