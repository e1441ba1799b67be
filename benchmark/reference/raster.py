"""Nearest-face fragments of a triangle mesh in plain PyTorch: the ray seeds
of the published step, which rasterizes the deformed template and takes
each pixel's nearest face at its barycentrics (SelfRecon's
``utils/FindSurfacePs.py:5-29``).

The rules, all in float32:

- pixel (col, row) is the point (col, row) of ``transform_points_screen``'s
  screen: pixel centres lie at whole numbers;
- a face takes part when its three vertices are in front of the camera
  (z > 0); both windings count;
- inside test: with area = (b - a) x (c - a) and the edge functions
  w0 = (c - b) x (P - b), w1 = (a - c) x (P - c), w2 = (b - a) x (P - a),
  each product and difference rounded in that order, P is inside when
  |area| > 1e-12 and w_i / area >= 0 for all three (edges and vertices are
  inside);
- depth: perspective-correct, z = 1 / max(sum_i b_i / z_i, 1e-12) with
  b_i = w_i / area;
- the nearest face has the least z; on an exact tie of z the lowest face id
  wins;
- barycentrics: t_i / max(t_0 + t_1 + t_2, 1e-12), t_i = b_i / z_i; an
  uncovered pixel has face -1 and barycentrics 0.

A face is tested at the pixels of its screen box rounded outwards
(floor of the least corner to ceil of the largest), so a sliver whose
rounded test would pass pixels farther out covers none of them here.

The port's mesh kernel (``csrc/mesh_raster.cu``) applies the same test and
depth, but on an exact tie the first entry of its cell's run wins
(``ops/mesh_kernels.py::pack_key``): a cell's run is sorted by entry id
k * F + face, k the cell's offset (2 dy + dx, each capped at 1) from the
first cell of the face's box (``ops/binning.py``).  So in a cell where both
faces' boxes start, or that both reach by the same offset, the lower face id
wins as here; otherwise the face at the lower offset wins.  ``ties`` counts
the pixels where two or more faces share the least z, the only pixels at
which the two rules can part.

Works through the faces in blocks of at most ``BLOCK`` (face, pixel) pairs
(a face whose box is larger takes a block alone), so a 1080x1080 image of
the fine template fits on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Camera, transform_points_screen

BLOCK = 1 << 22


class Fragments(NamedTuple):
    face: torch.Tensor      # (H, W) int64, -1 where no face covers
    bary: torch.Tensor      # (H, W, 3) perspective-correct barycentrics
    zbuf: torch.Tensor      # (H, W) depth, +inf where no face covers
    ties: int               # pixels whose least z two or more faces share


def _boxes(screen, faces, H: int, W: int):
    """Per face (F, 9) records p0 p1 p2 (col, row) and z0 z1 z2, the
    inclusive pixel box (x0, y0) and its size (nx, ny), 0 for a face that
    takes no part."""
    tri = screen[faces]                                     # (F, 3, 3)
    rec = torch.cat([tri[:, :, :2].reshape(-1, 6), tri[:, :, 2]], dim=1)
    x0 = torch.floor(tri[:, :, 0].amin(1)).clamp(0, W).long()
    x1 = torch.ceil(tri[:, :, 0].amax(1)).clamp(-1, W - 1).long()
    y0 = torch.floor(tri[:, :, 1].amin(1)).clamp(0, H).long()
    y1 = torch.ceil(tri[:, :, 1].amax(1)).clamp(-1, H - 1).long()
    ok = ((tri[:, :, 2] > 0.0).all(1) & torch.isfinite(tri).all(2).all(1)
          & (x1 >= x0) & (y1 >= y0))
    zero = torch.zeros_like(x0)
    return (rec, x0, y0, torch.where(ok, x1 - x0 + 1, zero),
            torch.where(ok, y1 - y0 + 1, zero))


def _blocks(sizes: torch.Tensor):
    """[start, end) face ranges whose pairs sum to at most BLOCK each (at
    least one face a range)."""
    ends = torch.cumsum(sizes, 0).cpu()
    out, f0, n = [], 0, sizes.shape[0]
    while f0 < n:
        base = int(ends[f0 - 1]) if f0 else 0
        f1 = max(int(torch.searchsorted(ends, base + BLOCK, right=True)),
                 f0 + 1)
        out.append((f0, min(f1, n)))
        f0 = f1
    return out


def _pairs(rec, x0, y0, nx, ny, f0: int, f1: int, W: int):
    """The (face, pixel) pairs of faces f0..f1 that pass the inside test:
    (face ids, flat pixels, z, b0, b1, b2, the face's vertex depths (M, 3))."""
    dev = rec.device
    per = (nx * ny)[f0:f1]
    face = torch.repeat_interleave(torch.arange(f0, f1, device=dev), per)
    local = torch.arange(face.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per)
    px = x0[face] + local % nx[face]
    py = y0[face] + local // nx[face]
    r = rec[face]
    X, Y = px.float(), py.float()
    ax, ay, bx, by, cx, cy = (r[:, j] for j in range(6))
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    w0 = (cx - bx) * (Y - by) - (cy - by) * (X - bx)
    w1 = (ax - cx) * (Y - cy) - (ay - cy) * (X - cx)
    w2 = (bx - ax) * (Y - ay) - (by - ay) * (X - ax)
    ok_area = area.abs() > 1e-12
    denom = torch.where(ok_area, area, torch.ones_like(area))
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & ok_area
    inv_z = b0 / r[:, 6] + b1 / r[:, 7] + b2 / r[:, 8]
    z = 1.0 / inv_z.clamp_min(1e-12)
    k = torch.nonzero(inside).squeeze(1)
    return (face[k], (py * W + px)[k], z[k], b0[k], b1[k], b2[k],
            r[k, 6:9])


@torch.no_grad()
def inside_pairs(screen: torch.Tensor, faces: torch.Tensor, H: int, W: int):
    """(face ids, flat pixels) of every (face, pixel) pair of the image
    that passes the inside test."""
    rec, x0, y0, nx, ny = _boxes(screen, faces.long(), H, W)
    out = [_pairs(rec, x0, y0, nx, ny, f0, f1, W)[:2]
           for f0, f1 in _blocks(nx * ny)]
    if not out:
        empty = torch.zeros(0, dtype=torch.long, device=screen.device)
        return empty, empty
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


@torch.no_grad()
def nearest_faces(screen: torch.Tensor, faces: torch.Tensor, H: int,
                  W: int) -> Fragments:
    """The nearest face at each pixel of an H x W image of the mesh whose
    vertices are at `screen` (V, 3) = (col, row, camera z), faces (F, 3)."""
    dev = screen.device
    rec, x0, y0, nx, ny = _boxes(screen, faces.long(), H, W)
    blocks = _blocks(nx * ny)
    zbuf = torch.full((H * W,), float("inf"), device=dev)
    for f0, f1 in blocks:
        _, pix, z, *_ = _pairs(rec, x0, y0, nx, ny, f0, f1, W)
        zbuf.scatter_reduce_(0, pix, z, "amin")
    n_faces = faces.shape[0]
    win = torch.full((H * W,), n_faces, dtype=torch.long, device=dev)
    hits = torch.zeros(H * W, dtype=torch.long, device=dev)
    bary = torch.zeros(H * W, 3, device=dev)
    for f0, f1 in blocks:
        face, pix, z, *_ = _pairs(rec, x0, y0, nx, ny, f0, f1, W)
        least = z == zbuf[pix]
        win.scatter_reduce_(0, pix[least], face[least], "amin")
        hits.scatter_add_(0, pix[least], torch.ones_like(pix[least]))
    for f0, f1 in blocks:
        face, pix, _, b0, b1, b2, zs = _pairs(rec, x0, y0, nx, ny, f0, f1, W)
        mine = face == win[pix]
        t = torch.stack([b0 / zs[:, 0], b1 / zs[:, 1], b2 / zs[:, 2]],
                        dim=1)[mine]
        ts = (t[:, 0] + t[:, 1] + t[:, 2]).clamp_min(1e-12)
        bary[pix[mine]] = t / ts[:, None]
    face = torch.where(win < n_faces, win, torch.full_like(win, -1))
    return Fragments(face.reshape(H, W), bary.reshape(H, W, 3),
                     zbuf.reshape(H, W), int((hits > 1).sum()))


def fragment_seeds(cam: Camera, verts: torch.Tensor, faces: torch.Tensor,
                   def_verts: torch.Tensor):
    """Per frame of def_verts (N, nv, 3), the template point at the
    barycentrics of the nearest face of the deformed template (0 where no
    face covers): (seeds (N, H, W, 3), covered (N, H, W), tied pixels)."""
    inits, covers, ties = [], [], 0
    for dv in def_verts:
        fr = nearest_faces(transform_points_screen(cam, dv), faces, cam.H,
                           cam.W)
        tri = faces[fr.face.clamp_min(0)].long()
        inits.append((verts[tri] * fr.bary[..., :, None]).sum(-2))
        covers.append(fr.face >= 0)
        ties += fr.ties
    return torch.stack(inits), torch.stack(covers), ties
