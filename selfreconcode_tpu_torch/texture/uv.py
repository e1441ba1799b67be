"""UV texture baking from posed frames (torch port of
``selfreconcode_tpu/texture/uv.py``; the reference's texture_mesh_prepare.py
and texture_mesh_extract.py without the VideoAvatar/opendr environment).

Per frame, on the camera's device: the mesh rasterizer (the CUDA mesh
kernel on the card, one launch per frame) gives each pixel its nearest face
and barycentrics; the pixel's weight is |n . v|^p, n the interpolated vertex
normal and v the unit vector to the camera, which sharply favours frontal
views.  Each hit pixel maps through its face's UVs to one texel.

Aggregation (texture_mesh_extract.py:62-153): per texel the K = 8
best-weighted frame samples are kept in slots, one candidate per texel per
frame (that frame's best-weight pixel for the texel), and the texel's colour
is the per-channel median over its filled slots; ``k_best=1`` is the
view-angle-weighted mean instead.  Unobserved texels are Telea-inpainted on
the host (``inpaint_texture``).

The slot insert and the median run in torch on the device, next to the
rasterizer's outputs: on the card a frame's fragments never leave it, and
only the finished texture comes back.  They keep JAX's numpy semantics
exactly: candidates are ordered by texel, then by weight descending, then
by pixel index (two stable sorts, as ``np.lexsort`` orders them); a slot is
replaced only by a strictly greater weight, the first weakest slot first;
and the median of an even count averages the two middle values, as
``np.nanmedian`` does (``torch.median`` would return the lower one).

Cells: JAX bakes at footprint 64 through its XLA rasterizer, whose cells
keep at most 48 faces each (its ops/rasterize.py:83-84, :124) and drop the
rest without a word; the port bins a wide face into every cell it covers
and never drops one, at its largest cells (32 px) by default.  The two
agree wherever JAX drops nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.rasterize import rasterize_mesh
from ..render.camera import Camera, cam_pos
from ..utils.meshops import vertex_normals


def load_obj_with_uv(path: str):
    """Minimal OBJ parser for `v`, `vt`, and `f v/vt ...` (the uvmap.obj the
    reference asks the user to produce, texture_mesh_prepare.py:30-41)."""
    verts, uvs, faces_v, faces_vt = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                vi, ti = [], []
                for p in parts[1:4]:
                    comps = p.split("/")
                    vi.append(int(comps[0]) - 1)
                    ti.append(int(comps[1]) - 1 if len(comps) > 1 and comps[1]
                              else int(comps[0]) - 1)
                faces_v.append(vi)
                faces_vt.append(ti)
    return (np.asarray(verts, np.float32), np.asarray(uvs, np.float32),
            np.asarray(faces_v, np.int32), np.asarray(faces_vt, np.int32))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-6)


def frame_weights(cam: Camera, verts: torch.Tensor, faces: torch.Tensor,
                  footprint: int, weight_pow: float):
    """One frame's fragments and view weights: (face ids (H, W) int64, -1
    where nothing was hit; barycentrics (H, W, 3); weight (H, W), 0 where
    nothing was hit)."""
    return view_weights(cam, verts, faces,
                        rasterize_mesh(cam, verts, faces, footprint),
                        weight_pow)


def view_weights(cam: Camera, verts: torch.Tensor, faces: torch.Tensor,
                 frags, weight_pow: float):
    """``frame_weights`` from given fragments (``rasterize_mesh``'s)."""
    hit = frags.pix_to_face >= 0
    tri = faces[frags.pix_to_face.clamp_min(0).long()]       # (H, W, 3)
    b = frags.bary[..., :, None]
    n = _unit((vertex_normals(verts, faces)[tri] * b).sum(-2))
    v = _unit(cam_pos(cam) - (verts[tri] * b).sum(-2))
    # |n.v|: the sign depends on the mesh's orientation; visibility is the
    # z-buffer's
    w = (n * v).sum(-1).abs().clamp(0.0, 1.0) ** weight_pow
    return (frags.pix_to_face.long(), frags.bary,
            torch.where(hit, w, torch.zeros_like(w)))


def texel_samples(face, bary, w, faces_vt, uvs, tex_size: int):
    """The weighted pixels' texels: (flat texel index ty * T + tx, weight,
    pixel mask), rounding as JAX's numpy does (uv.py:110-117)."""
    sel = w > 0
    uv_tri = uvs[faces_vt[face[sel]]]                    # (M, 3, 2)
    bs = bary[sel]
    uv = (uv_tri[:, 0] * bs[:, 0:1] + uv_tri[:, 1] * bs[:, 1:2]
          + uv_tri[:, 2] * bs[:, 2:3])
    top = tex_size - 1
    tx = torch.round(uv[:, 0] * top).long().clamp(0, top)
    ty = torch.round((1.0 - uv[:, 1]) * top).long().clamp(0, top)
    return ty * tex_size + tx, w[sel], sel


def best_per_texel(lin: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Indices of one candidate per texel: the greatest weight, the lowest
    index among equal weights (np.lexsort((-ws, lin))'s first of each
    texel)."""
    by_w = torch.argsort(-ws, stable=True)
    order = by_w[torch.argsort(lin[by_w], stable=True)]
    lin_s = lin[order]
    first = torch.ones_like(lin_s, dtype=torch.bool)
    first[1:] = lin_s[1:] != lin_s[:-1]
    return order[first]


def insert_slots(slot_w, slot_c, lin, ws, cols):
    """Each texel's candidate replaces its first weakest slot where its
    weight is strictly greater (slot_w (T*T, K), slot_c (T*T, K, 3), in
    place)."""
    pick = best_per_texel(lin, ws)
    pl, pw, pc = lin[pick], ws[pick], cols[pick]
    smin = slot_w[pl].argmin(-1)
    better = pw > slot_w[pl, smin]
    pl, smin = pl[better], smin[better]
    slot_w[pl, smin] = pw[better]
    slot_c[pl, smin] = pc[better]


def slot_median(slot_w: torch.Tensor, slot_c: torch.Tensor) -> torch.Tensor:
    """Per-channel median over each texel's filled slots, averaging the two
    middle values of an even count (np.nanmedian's rule); 0 where no slot is
    filled.  (T*T, K), (T*T, K, 3) -> (T*T, 3)."""
    filled = slot_w > 0.0
    n = filled.sum(-1)
    s = torch.where(filled[..., None], slot_c,
                    torch.full_like(slot_c, float("inf"))).sort(dim=1).values
    lo = ((n - 1) // 2).clamp_min(0)[:, None, None].expand(-1, 1, 3)
    hi = (n // 2).clamp_max(slot_w.shape[1] - 1)[:, None, None].expand(-1, 1,
                                                                         3)
    med = ((s.gather(1, lo) + s.gather(1, hi)) / 2.0)[:, 0]
    return torch.where((n > 0)[:, None], med, torch.zeros_like(med))


def bake_texture(cam: Camera, def_verts_per_frame, images, faces_v, faces_vt,
                 uvs, tex_size: int = 1024, weight_pow: float = 8.0,
                 footprint: int = 32, k_best: int = 8):
    """Accumulate a UV texture from posed frames seen by cam.

    def_verts_per_frame: (V, 3) deformed template vertices per frame;
    images: (H, W, 3) float images in [0, 1] per frame (numpy or tensors);
    faces_v / faces_vt / uvs as ``load_obj_with_uv`` returns them.  Runs on
    cam's device.  k_best > 1: per-texel median over the k best-viewing-angle
    frame samples; k_best <= 1: view-angle-weighted mean.  Returns numpy
    (texture (tex, tex, 3) float32 in [0, 1], weight (tex, tex) float32:
    the filled slots' weight sum, or the mean's weight sum)."""
    dev = cam.T.device
    faces = torch.as_tensor(np.asarray(faces_v), device=dev).long()
    with torch.no_grad():
        frags = (frame_weights(cam, torch.as_tensor(v, dtype=torch.float32,
                                                    device=dev),
                               faces, footprint, weight_pow)
                 for v in def_verts_per_frame)
        return accumulate_texture(frags, images, faces_vt, uvs, tex_size,
                                  k_best, dev)


def accumulate_texture(frags, images, faces_vt, uvs, tex_size: int,
                       k_best: int, device):
    """The aggregation half of ``bake_texture`` on ``device``: frags yields
    each frame's (face, bary, weight) as ``frame_weights`` gives them, in
    the order of images.  Returns numpy (texture, weight) as bake_texture
    does."""
    T = tex_size
    fvt = torch.as_tensor(np.asarray(faces_vt), device=device).long()
    uv_t = torch.as_tensor(np.asarray(uvs, np.float32), device=device)
    use_median = k_best > 1
    if use_median:
        slot_w = torch.zeros((T * T, k_best), device=device)
        slot_c = torch.zeros((T * T, k_best, 3), device=device)
    else:
        acc = torch.zeros((T * T, 3), dtype=torch.float64, device=device)
        wacc = torch.zeros((T * T,), dtype=torch.float64, device=device)
    with torch.no_grad():
        for (face, bary, w), img in zip(frags, images):
            img = torch.as_tensor(img, dtype=torch.float32, device=device)
            lin, ws, sel = texel_samples(face, bary, w, fvt, uv_t, T)
            cols = img[sel]
            if use_median:
                insert_slots(slot_w, slot_c, lin, ws, cols)
            else:
                acc.index_add_(0, lin, (cols * ws[:, None]).double())
                wacc.index_add_(0, lin, ws.double())
        if use_median:
            tex, weight = slot_median(slot_w, slot_c), slot_w.sum(-1)
        else:
            tex = (acc / wacc.clamp_min(1e-8)[:, None]).float()
            weight = wacc.float()
    return (tex.reshape(T, T, 3).cpu().numpy(),
            weight.reshape(T, T).cpu().numpy())


def inpaint_texture(tex: np.ndarray, weight: np.ndarray,
                    min_weight: float = 1e-6) -> np.ndarray:
    """Telea-inpaint texels no frame observed (texture_mesh_extract.py:150),
    on the host."""
    import cv2
    img8 = np.clip(tex * 255.0, 0, 255).astype(np.uint8)
    hole = (weight <= min_weight).astype(np.uint8)
    return cv2.inpaint(img8, hole, 3, cv2.INPAINT_TELEA)
