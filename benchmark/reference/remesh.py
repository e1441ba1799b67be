"""The template remesh in plain PyTorch: the octree sweep of the SDF and
marching cubes at a stage's resolutions, with the sweep box grown on the
sides the surface clips (the rule of the port's
``Trainer.discretize_sdf``), and the template vertices' normals the IGR fit
uses."""
from __future__ import annotations

import numpy as np
import torch

from .marching_cubes import marching_cubes
from .sparse_sdf import grid_world_coords, sparse_sdf_grid


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Sum of incident unit face normals, normalized (V, 3)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)
    fn = fn / torch.linalg.norm(fn, dim=-1, keepdim=True).clamp_min(eps)
    vn = torch.zeros_like(verts)
    for c in range(3):
        vn = vn.index_add(0, faces[:, c].long(), fn)
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp_min(eps)


def remesh(sdf_net, ratio: float, resolutions, b_min, b_max, grow_left,
           device, chunk: int = 65536):
    """(verts, faces, b_min, b_max, grow_left) of the zero level set: the
    box grows by 8% of its extent on each side the surface clips, up to
    three times, within the growth each side has left."""
    b_min = np.asarray(b_min, np.float32).copy()
    b_max = np.asarray(b_max, np.float32).copy()
    grow_left = np.asarray(grow_left, np.float64).copy()
    res = tuple(tuple(int(v) for v in r) for r in resolutions)

    def query(p):
        return torch.cat([sdf_net(c, ratio)[0] for c in torch.split(p, chunk)])

    for tries in range(4):
        with torch.no_grad():
            vol = sparse_sdf_grid(query, res, b_min, b_max, 0.0,
                                  device=device)
            spacing, origin = grid_world_coords(res[-1], b_min, b_max,
                                                device)
            mc = marching_cubes(vol, origin, spacing, 0.0)
        nv = mc.verts.shape[0]
        sides = mc.boundary_sides.copy()
        if mc.n_boundary > 0 and not sides.any():
            sides[[1, 3, 5]] = 1
        sides = np.where(grow_left[[0, 3, 1, 4, 2, 5]] > 0, sides, 0)
        if not (sides.any() and nv > 0 and tries < 3):
            break
        ext = b_max - b_min
        lo = np.where(sides[[0, 2, 4]] > 0,
                      np.minimum(0.08 * ext, grow_left[:3]), 0.0)
        hi = np.where(sides[[1, 3, 5]] > 0,
                      np.minimum(0.08 * ext, grow_left[3:]), 0.0)
        b_min = (b_min - lo).astype(np.float32)
        b_max = (b_max + hi).astype(np.float32)
        grow_left[:3] -= lo
        grow_left[3:] -= hi
    if nv == 0:
        raise RuntimeError("the SDF has no zero level set")
    return mc.verts, mc.faces, b_min, b_max, grow_left
