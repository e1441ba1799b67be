"""Marching-cubes case tables, generated programmatically at import time.

Instead of shipping the classic 256x16 triangle table as opaque constants,
we derive an equivalent table from first principles by walking iso-surface
polygons on the cube:

  * cube corners are indexed by bits (ix | iy<<1 | iz<<2) of their unit
    coordinates;
  * the 12 edges connect corner pairs; an edge is "crossing" iff its two
    corners have different in/out signs;
  * on each of the 6 faces we run marching squares with the fixed,
    sign-consistent ambiguity rule "separate the negative (inside) corners":
    crossings are paired iff they bound the same maximal arc of inside
    corners along the face boundary.  Because the rule depends only on the
    shared face's corner signs, adjacent cubes always agree -> watertight.
  * the pairings give each crossing vertex exactly two links -> disjoint
    closed polygons, which we orient against the trilinear field gradient
    (inside=-1, outside=+1) and fan-triangulate.

This plays the role of the device-constant tables in the reference CUDA MC
(MCGpu/CudaKernels.cu) with a deterministic, re-derivable construction.
"""
from __future__ import annotations

import numpy as np

# corner i has coords CORNERS[i] in {0,1}^3, bit order (x, y<<1, z<<2)
CORNERS = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
                   dtype=np.float64)

# 12 edges as corner index pairs; edge id encodes (axis, origin corner)
# axis-x edges: origin corners with x=0 -> 0,2,4,6 ; similarly y, z.
EDGES = []
for axis in range(3):
    for c in range(8):
        if not (c >> axis) & 1:
            EDGES.append((c, c | (1 << axis)))
EDGES = np.array(EDGES, dtype=np.int64)  # (12, 2)
N_EDGES = 12

# faces: (normal axis, side), each with its 4 corners in cyclic order
def _face_corners(axis: int, side: int):
    a1, a2 = [a for a in range(3) if a != axis]
    cyc = [(0, 0), (1, 0), (1, 1), (0, 1)]  # cyclic in (a1, a2)
    out = []
    for u, v in cyc:
        c = (side << axis) | (u << a1) | (v << a2)
        out.append(c)
    return out

FACES = [_face_corners(axis, side) for axis in range(3) for side in range(2)]


_EDGE_LOOKUP = {}
for eid in range(12):
    c0, c1 = EDGES[eid]
    _EDGE_LOOKUP[(min(c0, c1), max(c0, c1))] = eid


def _face_links(inside, face):
    """Marching squares on one face -> list of (edge_id, edge_id) links."""
    signs = [inside[c] for c in face]
    # boundary crossings between consecutive corners
    crossings = []  # (position index in cyclic boundary, edge_id)
    for k in range(4):
        c0, c1 = face[k], face[(k + 1) % 4]
        if signs[k] != signs[(k + 1) % 4]:
            crossings.append((k, _EDGE_LOOKUP[(min(c0, c1), max(c0, c1))]))
    if not crossings:
        return []
    # pair crossings bounding the same maximal arc of inside corners:
    # walk the cyclic boundary; an arc between crossing k and the next
    # crossing has uniform sign = sign of corner (k+1)
    links = []
    m = len(crossings)
    for i in range(m):
        k_i, e_i = crossings[i]
        k_j, e_j = crossings[(i + 1) % m]
        arc_corner = face[(k_i + 1) % 4]
        if inside[arc_corner]:  # link the two crossings bounding an inside arc
            links.append((e_i, e_j))
    return links


def _edge_point(eid: int) -> np.ndarray:
    c0, c1 = EDGES[eid]
    return (CORNERS[c0] + CORNERS[c1]) / 2.0


def _field_gradient(inside, p: np.ndarray) -> np.ndarray:
    """Gradient of the trilinear interpolation of corner values (+1 out, -1 in)."""
    vals = np.where(inside, -1.0, 1.0)
    g = np.zeros(3)
    eps = 1e-4
    for a in range(3):
        for s, f in ((1, 1.0), (-1, -1.0)):
            q = p.copy()
            q[a] += s * eps
            q = np.clip(q, 0, 1)
            # trilinear value at q
            val = 0.0
            for c in range(8):
                w = 1.0
                for b in range(3):
                    cb = (c >> b) & 1
                    w *= q[b] if cb else (1 - q[b])
                val += w * vals[c]
            g[a] += f * val
    return g


def _build_case(case: int):
    inside = [(case >> c) & 1 == 1 for c in range(8)]
    links = []
    for face in FACES:
        links.extend(_face_links(inside, face))
    if not links:
        return []
    # adjacency: each crossing edge appears in exactly two links
    adj = {}
    for a, b in links:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    # trace closed polygons
    visited = set()
    tris = []
    for start in adj:
        if start in visited:
            continue
        poly = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxts = [n for n in adj[cur] if n != prev]
            nxt = nxts[0] if nxts else adj[cur][0]
            if nxt == start:
                break
            poly.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        if len(poly) < 3:
            continue
        # orient: polygon normal should align with field gradient (in->out)
        pts = np.array([_edge_point(e) for e in poly])
        centroid = pts.mean(0)
        normal = np.zeros(3)
        for i in range(len(poly)):
            normal += np.cross(pts[i] - centroid, pts[(i + 1) % len(poly)] - centroid)
        grad = _field_gradient(inside, centroid)
        if np.dot(normal, grad) < 0:
            poly = poly[::-1]
        for i in range(1, len(poly) - 1):
            tris.append((poly[0], poly[i], poly[i + 1]))
    return tris


def build_tables(max_tris: int = 8):
    """Returns (tri_table (256, max_tris, 3) int32 of edge ids, -1 padded,
    n_tris (256,) int32)."""
    tri_table = -np.ones((256, max_tris, 3), np.int32)
    n_tris = np.zeros((256,), np.int32)
    for case in range(256):
        tris = _build_case(case)
        assert len(tris) <= max_tris, (case, len(tris))
        n_tris[case] = len(tris)
        for i, t in enumerate(tris):
            tri_table[case, i] = t
    return tri_table, n_tris


TRI_TABLE, N_TRIS = build_tables()
MAX_TRIS = TRI_TABLE.shape[1]
