"""Marching cubes with exact-size outputs (torch port of
``selfreconcode_tpu/ops/marching_cubes.py``).

Vertices are the crossing grid edges in edge-id order (axis-major, C-order
within an axis), positioned by iso interpolation from the edge's origin
corner; faces are the table triangles of the surface cubes in C-order.  Same
numbering as the JAX package.  One difference: the JAX package leaves a
crossing on a +boundary edge (no cube owns it) at (0, 0, 0), though the
neighbouring cube's faces use it, which gives long triangles to the origin
whenever the surface leaves the sweep box; here it sits on its edge like
every other crossing.  Such crossings are still counted in n_boundary.
boundary_sides counts inside samples on each bbox face (x-, x+, y-, y+, z-,
z+).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import trace
from .mc_tables import MAX_TRIS, N_TRIS, TRI_TABLE

_EDGE_AXIS = np.repeat(np.arange(3), 4).astype(np.int64)
_EDGE_ORIGIN = np.zeros((12, 3), np.int64)
for _axis in range(3):
    _k = 0
    for _c in range(8):
        if not (_c >> _axis) & 1:
            _EDGE_ORIGIN[_axis * 4 + _k] = [(_c >> 0) & 1, (_c >> 1) & 1,
                                            (_c >> 2) & 1]
            _k += 1
_CORNER_OFF = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)], np.int64)


class MCResult(NamedTuple):
    verts: torch.Tensor           # (nv, 3) world space
    faces: torch.Tensor           # (nf, 3) int64
    n_boundary: int               # crossings on ownerless +boundary edges
    boundary_sides: np.ndarray    # (6,) inside samples per bbox face


def marching_cubes(volume: torch.Tensor, origin, spacing,
                   iso: float) -> MCResult:
    """volume (X, Y, Z); world = origin + idx * spacing; inside = sdf < iso."""
    X, Y, Z = volume.shape
    dev = volume.device
    origin = torch.as_tensor(origin, dtype=volume.dtype, device=dev)
    spacing = torch.as_tensor(spacing, dtype=volume.dtype, device=dev)
    inside = volume < iso
    cross = [inside[:-1] != inside[1:], inside[:, :-1] != inside[:, 1:],
             inside[:, :, :-1] != inside[:, :, 1:]]
    sizes = [c.numel() for c in cross]
    flat_cross = torch.cat([c.reshape(-1) for c in cross])
    vid = torch.cumsum(flat_cross.long(), 0) - flat_cross.long()
    trace.count("host_syncs", 2)     # n_boundary, boundary_sides
    n_boundary = int(cross[0][:, -1, :].sum() + cross[0][:, :-1, -1].sum()
                     + cross[1][-1, :, :].sum() + cross[1][:-1, :, -1].sum()
                     + cross[2][-1, :, :].sum() + cross[2][:-1, -1, :].sum())
    boundary_sides = torch.stack([
        inside[0].sum(), inside[-1].sum(), inside[:, 0].sum(),
        inside[:, -1].sum(), inside[:, :, 0].sum(), inside[:, :, -1].sum(),
    ]).cpu().numpy()

    # vertex positions: iso interpolation along each crossing edge, also on
    # a +boundary face (an edge no cube owns, which JAX leaves at (0, 0, 0)
    # though the faces of its neighbouring cube use it)
    verts = []
    for axis in range(3):
        trace.count("host_syncs", 2)
        ijk = torch.nonzero(cross[axis])
        step = torch.zeros(3, dtype=torch.long, device=dev)
        step[axis] = 1
        i, j, k = ijk.unbind(1)
        v0 = volume[i, j, k]
        v1 = volume[i + step[0], j + step[1], k + step[2]]
        denom = v1 - v0
        t = torch.where(denom.abs() > 1e-12, (iso - v0) / denom,
                        torch.full_like(v0, 0.5)).clamp(0.0, 1.0)
        base = ijk.to(volume.dtype)
        base[:, axis] = base[:, axis] + t
        verts.append(origin + base * spacing)
    verts = torch.cat(verts)

    # faces: table triangles of the surface cubes, cube-major in C-order
    case = torch.zeros((X - 1, Y - 1, Z - 1), dtype=torch.long, device=dev)
    for c in range(8):
        ox, oy, oz = (int(v) for v in _CORNER_OFF[c])
        case = case + (inside[ox:X - 1 + ox, oy:Y - 1 + oy,
                              oz:Z - 1 + oz].long() << c)
    # the tables' copies, the cubes' nonzero, the triangles' selection
    trace.count("host_syncs", 6)
    n_tris = torch.as_tensor(N_TRIS, device=dev).long()[case]
    cubes = torch.nonzero(n_tris > 0)                          # (A, 3)
    ccase = case[cubes[:, 0], cubes[:, 1], cubes[:, 2]]
    e_axis = torch.as_tensor(_EDGE_AXIS, device=dev)
    e_orig = torch.as_tensor(_EDGE_ORIGIN, device=dev)
    i = cubes[:, 0:1] + e_orig[None, :, 0]
    j = cubes[:, 1:2] + e_orig[None, :, 1]
    k = cubes[:, 2:3] + e_orig[None, :, 2]
    g0 = (i * Y + j) * Z + k
    g1 = sizes[0] + (i * (Y - 1) + j) * Z + k
    g2 = sizes[0] + sizes[1] + (i * Y + j) * (Z - 1) + k
    geid = torch.where(e_axis == 0, g0, torch.where(e_axis == 1, g1, g2))
    edge_vid = vid[geid]                                       # (A, 12)
    local = torch.as_tensor(TRI_TABLE, device=dev).long()[ccase]  # (A,T,3)
    tri_valid = local[..., 0] >= 0
    tvids = torch.gather(edge_vid[:, None, :].expand(-1, MAX_TRIS, 12), 2,
                         local.clamp_min(0))
    return MCResult(verts=verts, faces=tvids[tri_valid],
                    n_boundary=n_boundary, boundary_sides=boundary_sides)
