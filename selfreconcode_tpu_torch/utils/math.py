"""Core math primitives (torch port of ``selfreconcode_tpu/utils/math.py``).

Every function is plain torch on tensors of any device and is
differentiable to any order; the reference equations are cited per function
in the JAX module.
"""
from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from . import trace


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z), (..., 4) -> rotation matrices (..., 3, 3);
    normalizes first."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N,3) -> rotation matrices (N,3,3) via the half-angle
    quaternion (norm of theta + 1e-8, as the reference)."""
    l1norm = torch.linalg.norm(theta + 1e-8, dim=-1, keepdim=True)
    normalized = theta / l1norm
    half = l1norm * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat2mat(quat)


def gm_robust(x: torch.Tensor, c: float, square: bool = False) -> torch.Tensor:
    """Geman-McClure robustifier."""
    if square:
        return 2.0 * x / (c * c) / (x / (c * c) + 4.0)
    return 2.0 * x * x / (c * c) / (x * x / (c * c) + 4.0)


def inv3x3(m: torch.Tensor, det_eps: float = 1e-4):
    """Batched cofactor 3x3 inverse with singularity mask.

    Returns (inv, check): check is False where |det| < det_eps, and the
    inverse is zero there."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    check = det.abs() >= det_eps
    safe_det = torch.where(check, det, torch.ones_like(det))
    inv = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co10, co11, co12], dim=-1),
        torch.stack([co20, co21, co22], dim=-1),
    ], dim=-2) / safe_det[..., None, None]
    inv = torch.where(check[..., None, None], inv, torch.zeros_like(inv))
    return inv, check


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3); differentiable everywhere
    (no LU, so singular inputs have a finite gradient)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric [v]_x with (v x u) = cross_matrix(v) @ u."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
    ], dim=-2)


def dct_basis(k: int, n: int) -> np.ndarray:
    """Orthonormal DCT-II basis row k of length n."""
    assert k < n
    basis = np.array([np.pi * (float(i) + 0.5) * k / float(n)
                      for i in range(n)])
    scale = 1.0 / np.sqrt(float(n)) if k == 0 else np.sqrt(2.0 / float(n))
    return (np.cos(basis) * scale).astype(np.float32)


def dct_space(k: int, n: int) -> np.ndarray:
    """First k DCT basis rows, (k, n)."""
    return np.stack([dct_basis(i, n) for i in range(k)])


def dct_null_space(k: int, n: int) -> np.ndarray:
    """DCT rows k..n-1 (the high-frequency null space), (n-k, n)."""
    return np.stack([dct_basis(i, n) for i in range(k, n)])


def eigvals_sym3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form (Cardano) eigenvalues of batched symmetric 3x3 matrices,
    ascending.

    No iterative polish: a Newton polish on the characteristic polynomial
    has f'(lam) ~ 0 at repeated roots (the isotropic case, common early in
    training) and turned the whole step into NaN.  The degeneracy test is
    relative, and the division is guarded so the untaken branch leaks no
    inf/nan gradient."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    d = A - q[..., None, None] * eye
    p2 = (d * d).sum((-2, -1))
    scale2 = (A * A).sum((-2, -1)) + eps
    degenerate = p2 <= 1e-12 * scale2
    p2_safe = torch.where(degenerate, torch.ones_like(p2), p2)
    p = torch.sqrt(p2_safe / 6.0)
    B = d / p[..., None, None]
    r = torch.clamp(det3x3(B) / 2.0, -1.0 + 1e-6, 1.0 - 1e-6)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * _pymath.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    lam = torch.stack([e3, e2, e1], dim=-1)
    return torch.where(degenerate[..., None], q[..., None].expand_as(lam), lam)


def log_singular_values_sq_sum(jac: torch.Tensor,
                               eps: float = 1e-12) -> torch.Tensor:
    """sum_i log(sigma_i)^2 for batched 3x3 Jacobians, with sigma_i^2 the
    closed-form eigenvalues of J^T J."""
    jtj = torch.einsum("...ji,...jk->...ik", jac, jac)
    eig = torch.clamp(eigvals_sym3(jtj), min=eps)
    logs = 0.5 * torch.log(eig)
    return (logs * logs).sum(-1)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True),
                           min=eps)


def make_homo(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(...,3,3),(...,3) -> (...,4,4) rigid transform."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    trace.count("host_syncs")
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rigid_inverse_homo(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of the rigid transform (R, t) as a 4x4 matrix."""
    Rt = R.transpose(-1, -2)
    return make_homo(Rt, -torch.einsum("...ij,...j->...i", Rt, t))
