"""Perspective camera with the reference's rectified screen<->NDC convention
(frozen copy of the port's ``selfreconcode_tpu_torch/render/camera.py``).

R is the cam->world rotation as stored (world->cam is p @ R + T); screen
coordinates are (col, row) with the align_corners=False rectification.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mathops import quat2mat


@dataclass
class Camera:
    """One camera shared by every frame; tensors so they stay optimizable."""
    focal: torch.Tensor       # (2,) fx, fy in pixels
    principal: torch.Tensor   # (2,) cx, cy in pixels
    R: torch.Tensor           # (3, 3) cam->world rotation
    T: torch.Tensor           # (3,) world->cam translation
    H: int
    W: int


def make_camera(focal, principal, quat, T, H: int, W: int,
                device="cpu") -> Camera:
    """From the dataset's camera.npz parameterization (fx,fy,cx,cy,quat,T)."""
    def t(x, n):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=device).reshape(n)
    R = quat2mat(t(quat, 4).reshape(1, 4))[0]
    return Camera(focal=t(focal, 2), principal=t(principal, 2), R=R,
                  T=t(T, 3), H=H, W=W)


def cam_pos(cam: Camera) -> torch.Tensor:
    """Camera center in world coords: -R @ T."""
    return -(cam.R @ cam.T)


def view_rays(cam: Camera, pix: torch.Tensor) -> torch.Tensor:
    """pix (N, 3) = [col, row, 1] -> world-space unit rays (N, 3)."""
    fx, fy = cam.focal[0], cam.focal[1]
    cx, cy = cam.principal[0], cam.principal[1]
    rays = torch.stack([
        -pix[:, 0] / fx + pix[:, 2] * cx / fx,
        -pix[:, 1] / fy + pix[:, 2] * cy / fy,
        pix[:, 2],
    ], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    return rays @ cam.R.T


def world_to_cam(cam: Camera, pts: torch.Tensor) -> torch.Tensor:
    return pts @ cam.R + cam.T


def transform_points_screen(cam: Camera, pts: torch.Tensor) -> torch.Tensor:
    """World (N, 3) -> (col, row, z_cam) with the rectified NDC convention."""
    p = world_to_cam(cam, pts)
    half_w, half_h = cam.W / 2.0, cam.H / 2.0
    fx_ndc = cam.focal[0] / half_w
    fy_ndc = cam.focal[1] / half_h
    px_ndc = 1.0 - 1.0 / cam.W - cam.principal[0] / half_w
    py_ndc = 1.0 - 1.0 / cam.H - cam.principal[1] / half_h
    inv_z = 1.0 / p[:, 2]
    x_ndc = fx_ndc * p[:, 0] * inv_z + px_ndc
    y_ndc = fy_ndc * p[:, 1] * inv_z + py_ndc
    screen_x = (cam.W - 1.0) / 2.0 - cam.W * x_ndc / 2.0
    screen_y = (cam.H - 1.0) / 2.0 - cam.H * y_ndc / 2.0
    return torch.stack([screen_x, screen_y, p[:, 2]], dim=-1)


def ang_threshold(cam: Camera, pixoffset: float = 0.4) -> float:
    """Minimal sub-pixel ray angle in degrees (host-side)."""
    H, W = float(cam.H), float(cam.W)
    cx, cy = (float(v) for v in cam.principal.detach().cpu())
    fx, fy = (float(v) for v in cam.focal.detach().cpu())

    def ang(r1, r2):
        r1, r2 = np.asarray(r1), np.asarray(r2)
        s = np.linalg.norm(np.cross(r1, r2)) / (np.linalg.norm(r1)
                                                * np.linalg.norm(r2))
        return float(np.arcsin(np.clip(s, 0, 1)) / np.pi * 180.0)

    return min(
        ang([(W - cx) / fx, 0, 1], [(W + pixoffset - cx) / fx, 0, 1]),
        ang([-cx / fx, 0, 1], [(pixoffset - cx) / fx, 0, 1]),
        ang([0, (H - cy) / fy, 1], [0, (H + pixoffset - cy) / fy, 1]),
        ang([0, -cy / fy, 1], [0, (pixoffset - cy) / fy, 1]),
    )
