"""Ray/surface points and their implicit-function-theorem gradient (frozen
copy of the Gauss-Newton path of the port's
``selfreconcode_tpu_torch/engine/surface.py``).

Each ray's canonical point p solves F(p, theta) = [sdf(p); v x (D(p) - c)] = 0
for a fixed number of Gauss-Newton iterations: p -= (B^T B)^-1 B^T F,
B = dF/dp, each step clipped to ``step_clip``.

The iterates carry no graph: every iteration differentiates w.r.t. a fresh
leaf copy of p only.  The gradient w.r.t. theta (SDF
and translator parameters, dcond, poses, trans, rays, camera centre) is
dp = -M dF/dtheta with M = (B^T B)^-1 B^T and B at the solver's point,
masked to converged rays with an invertible B^T B.  It is attached without
an autograd.Function:

    p = p* + (corr - corr.detach()),   corr = -M F(p*, theta)

has p*'s value and exactly the IFT gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .deformer import deformer_apply, deformer_jacobian
from .mathops import cross_matrix, inv3x3
from .sdf import sdf_value_and_grad


class SurfaceConfig(NamedTuple):
    n_iters: int = 10
    dthreshold: float = 5e-5
    athreshold_deg: float = 0.02   # from camera.ang_threshold
    step_clip: float = 0.1         # max per-iteration displacement (Newton)


def _converged(sdf, sin_ang, cfg: SurfaceConfig):
    ang_deg = torch.arcsin(sin_ang.clamp(0.0, 1.0)) * 180.0 / math.pi
    return (sdf.abs() < cfg.dthreshold) & (ang_deg < cfg.athreshold_deg)


def _constraint(sdf, d, rays, cam_c):
    """F's ray part v x (D - c) and the sine of the ray/point angle."""
    v_cross = cross_matrix(rays)
    direct = d - cam_c[None, :]
    Fc = torch.einsum("nij,nj->ni", v_cross, direct)
    sin_ang = (torch.linalg.norm(Fc, dim=-1)
               / torch.linalg.norm(direct, dim=-1).clamp_min(1e-12)
               / torch.linalg.norm(rays, dim=-1).clamp_min(1e-12))
    return Fc, v_cross, sin_ang


def _constraint_and_B(nets, pts, batch_inds, dcond, poses, trans, rays,
                      cam_c, ratio_sdf, ratio_def):
    """Detached F (N,4), B = dF/dp (N,4,3), sdf, sin_ang at pts."""
    sdf_net, translator, skinner = nets
    p = pts.detach()
    sdf, grad_p, _ = sdf_value_and_grad(sdf_net, p, ratio_sdf,
                                        create_graph=False)
    jac, d = deformer_jacobian(translator, skinner, p, batch_inds, dcond,
                               poses, trans, ratio_def, create_graph=False)
    Fc, v_cross, sin_ang = _constraint(sdf.detach(), d.detach(), rays, cam_c)
    F = torch.cat([sdf.detach()[:, None], Fc], dim=1)
    B = torch.cat([grad_p[:, None, :],
                   torch.einsum("nij,njk->nik", v_cross, jac.detach())], dim=1)
    return F, B, sdf.detach(), sin_ang


def _detached(dcond, poses, trans, rays, cam_c):
    return dict(dcond=dcond.detach(), poses=poses.detach(),
                trans=trans.detach(), rays=rays.detach(),
                cam_c=cam_c.detach())


def _newton(nets, cfg: SurfaceConfig, ratio_sdf, ratio_def, det, init_pts,
            batch_inds):
    """The Newton loop on detached inputs: (pts, converged, B at pts)."""
    pts = init_pts.detach()
    done = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    for _ in range(cfg.n_iters):
        F, B, sdf, sin_ang = _constraint_and_B(nets, pts, batch_inds,
                                               ratio_sdf=ratio_sdf,
                                               ratio_def=ratio_def, **det)
        done = done | _converged(sdf, sin_ang, cfg)
        btb = torch.einsum("nki,nkj->nij", B, B) + 1e-9 * eye
        inv, ok = inv3x3(btb, det_eps=1e-12)
        dp = -torch.einsum("nij,nkj,nk->ni", inv, B, F)
        nrm = torch.linalg.norm(dp, dim=-1, keepdim=True)
        dp = dp * torch.clamp(cfg.step_clip / nrm.clamp_min(1e-20), max=1.0)
        dp = torch.where((done | ~ok)[:, None], torch.zeros_like(dp), dp)
        pts = pts + dp
    F, B, sdf, sin_ang = _constraint_and_B(nets, pts, batch_inds,
                                           ratio_sdf=ratio_sdf,
                                           ratio_def=ratio_def, **det)
    return pts, done | _converged(sdf, sin_ang, cfg), B


def surface_points(nets, cfg: SurfaceConfig, ratio_sdf, ratio_def, dcond,
                   poses, trans, rays, cam_c, init_pts, batch_inds):
    """nets = (sdf_net, translator, skinner).  Returns (pts (N,3) carrying
    the IFT gradient, converged mask (N,))."""
    det = _detached(dcond, poses, trans, rays, cam_c)
    pts, done, B = _newton(nets, cfg, ratio_sdf, ratio_def, det, init_pts,
                           batch_inds)

    # IFT: M = (B^T B)^-1 B^T at the solution, masked like the JAX backward
    btb_inv, inv_ok = inv3x3(torch.einsum("nki,nkj->nij", B, B))
    M = torch.einsum("nij,nkj->nik", btb_inv, B)                 # (N,3,4)
    keep = (done & inv_ok)[:, None, None]
    M = torch.where(keep, M, torch.zeros_like(M))

    sdf_net, translator, skinner = nets
    sdf_theta = sdf_net(pts, ratio_sdf)[0]
    d_theta, _ = deformer_apply(translator, skinner, pts, batch_inds, dcond,
                                poses, trans, ratio_def)
    Fc_theta, _, _ = _constraint(sdf_theta, d_theta, rays, cam_c)
    F_theta = torch.cat([sdf_theta[:, None], Fc_theta], dim=1)
    F_theta = torch.where(keep[:, :, 0], F_theta, torch.zeros_like(F_theta))
    corr = -torch.einsum("nik,nk->ni", M, F_theta)
    return pts + (corr - corr.detach()), done
