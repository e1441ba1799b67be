"""Mesh helpers (torch port of the parts of
``selfreconcode_tpu/utils/meshops.py`` the training slice uses)."""
from __future__ import annotations

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

