"""Hard Phong shading over rasterized fragments (torch port of
``selfreconcode_tpu/render/shading.py``): white vertex colours, one point
light, one face per pixel, vertex normals interpolated with the fragment
barycentrics, ambient + diffuse + specular, double-sided, white background.
"""
from __future__ import annotations

import torch

from ..ops.rasterize import Fragments, rasterize_mesh
from ..utils.meshops import vertex_normals
from .camera import Camera, cam_pos


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-6)


def phong_shade(cam: Camera, verts, faces, frags: Fragments, light_pos,
                ambient=0.3, diffuse=0.7, specular=0.2, shininess=64.0,
                color=(1.0, 1.0, 1.0)):
    """Shade fragments -> (image (H, W, 3) in [0, 1], hit mask (H, W))."""
    vn = vertex_normals(verts, faces)
    hit = frags.pix_to_face >= 0
    tri = faces[frags.pix_to_face.clamp_min(0).long()].long()    # (H,W,3)
    w = frags.bary[..., :, None]
    n = _unit((vn[tri] * w).sum(-2))
    p = (verts[tri] * w).sum(-2)
    l = _unit(light_pos - p)
    v = _unit(cam_pos(cam) - p)
    # double-sided: normals flipped toward the camera
    n = torch.where((n * v).sum(-1, keepdim=True) < 0, -n, n)
    ndotl = (n * l).sum(-1).clamp(0.0, 1.0)
    spec = _unit(l + v)
    spec = (n * spec).sum(-1).clamp(0.0, 1.0) ** shininess
    base = torch.as_tensor(color, dtype=verts.dtype, device=verts.device)
    img = ((ambient + diffuse * ndotl[..., None]) * base
           + specular * spec[..., None]).clamp(0.0, 1.0)
    img = torch.where(hit[..., None], img, torch.ones_like(img))
    return img, hit


def render_mesh_phong(cam: Camera, verts, faces, light_pos,
                      footprint: int = 8):
    frags = rasterize_mesh(cam, verts, faces, footprint)
    return phong_shade(cam, verts, faces, frags, light_pos)
