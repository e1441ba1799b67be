"""Ray/surface points and their implicit-function-theorem gradient (torch
port of ``selfreconcode_tpu/engine/surface.py``).

Each ray's canonical point p solves F(p, theta) = [sdf(p); v x (D(p) - c)] = 0
for a fixed number of iterations (``optimize_surface_points``; at inference
it may stop early), by one of two solvers:

* Gauss-Newton (``newton=True``, the default): p -= (B^T B)^-1 B^T F,
  B = dF/dp, each step clipped to ``step_clip``;
* the reference's Cauchy step (``newton=False``, utils/FindSurfacePs.py:
  114-163): p += t g with g = dL/dp and t = -L / |g|^2 on the scalar
  L = W1 |sdf| + W2 sin(angle).  Its ray term is ~10x weaker than the sdf
  term, so it 2-cycles and converges fewer rays; the A/B tools
  (``tools/``) select it through ``StageStatic.surf_newton``.

The iterates carry no graph: every iteration differentiates w.r.t. a fresh
leaf copy of p only.  Whichever solver ran, the gradient w.r.t. theta (SDF
and translator parameters, dcond, poses, trans, rays, camera centre) is
dp = -M dF/dtheta with M = (B^T B)^-1 B^T and B at the solver's point,
masked to converged rays with an invertible B^T B.  It is attached without
an autograd.Function:

    p = p* + (corr - corr.detach()),   corr = -M F(p*, theta)

has p*'s value and exactly the IFT gradient.

The solve skins at the poses' forward-kinematics transforms, which its
caller computes (``surface_points`` takes them; the solve reads them
detached).  ``surface_points`` is the solve (``solve_surface``: the points,
their converged mask and B) followed by the correction (``ift_points``);
the training step calls the two apart, the correction inside the outer
pass's CUDA graph.  In training on the card (CUDA tensors,
Newton, no early exit, grad enabled) the fixed-count Newton loop is one
CUDA graph, captured at the first solve of its shapes and replayed at every
later one (``_NewtonGraph``): the loop is thousands of small kernels that
the host would otherwise launch one by one.  Everywhere else (the CPU,
inference's early exit, the Cauchy step) the same loop runs eagerly.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import NamedTuple

import torch

from ..models.deformer import deformer_apply_transforms, point_jacobian
from ..models.sdf import sdf_value_and_grad
from ..models.skinner import fk_transforms
from ..utils import trace
from ..utils.math import cross_matrix, inv3x3
from ..utils.pe import band_weights


class SurfaceConfig(NamedTuple):
    n_iters: int = 10
    dthreshold: float = 5e-5
    athreshold_deg: float = 0.02   # from camera.ang_threshold
    newton: bool = True            # False: the reference's Cauchy step
    step_clip: float = 0.1         # max per-iteration displacement (Newton)
    # early_exit=True stops once every point has converged (a host check of
    # done.all() per iteration, in either solver; done points no longer
    # move, so the result is the same).  On at inference, where 30
    # iterations are asked for and Newton converges in a few; off in
    # training, which wants no host sync.
    early_exit: bool = False


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


def _constraint_and_B(nets, pts, batch_inds, dcond, A, trans, rays, cam_c,
                      ratio_sdf, ratio_def):
    """Detached F (N,4), B = dF/dp (N,4,3), sdf, sin_ang at pts; A are the
    poses' FK transforms."""
    sdf_net, translator, skinner = nets
    p = pts.detach()
    sdf, grad_p, _ = sdf_value_and_grad(sdf_net, p, ratio_sdf,
                                        create_graph=False)
    jac, d = point_jacobian(
        lambda q: deformer_apply_transforms(translator, skinner, q,
                                            batch_inds, dcond, A, trans,
                                            ratio_def)[0],
        p, create_graph=False)
    Fc, v_cross, sin_ang = _constraint(sdf.detach(), d.detach(), rays, cam_c)
    F = torch.cat([sdf.detach()[:, None], Fc], dim=1)
    B = torch.cat([grad_p[:, None, :],
                   torch.einsum("nij,njk->nik", v_cross, jac.detach())], dim=1)
    return F, B, sdf.detach(), sin_ang


# The Cauchy step's loss weights (utils/FindSurfacePs.py:114-163).
W1, W2 = 3.05, 1.0


def _point_losses(nets, pts, batch_inds, dcond, A, trans, rays, cam_c,
                  ratio_sdf, ratio_def):
    """The Cauchy step's per-point loss W1 |sdf| + W2 sin(angle), sdf and
    sin(angle) at pts.  Unlike ``_constraint``'s, this sine is
    |(D - c) x v| / |D - c| with no division by |v| (JAX surface.py:
    66-75)."""
    sdf_net, translator, skinner = nets
    sdf = sdf_net(pts, ratio_sdf)[0]
    d, _ = deformer_apply_transforms(translator, skinner, pts, batch_inds,
                                     dcond, A, trans, ratio_def)
    direct = d - cam_c[None, :]
    sin_ang = (torch.linalg.norm(torch.linalg.cross(direct, rays), dim=-1)
               / torch.linalg.norm(direct, dim=-1).clamp_min(1e-12))
    return W1 * sdf.abs() + W2 * sin_ang, sdf, sin_ang


def _detached(dcond, A, trans, rays, cam_c):
    """The solve's inputs, detached: every iteration skins at the poses'
    FK transforms A."""
    return dict(dcond=dcond.detach(), A=A.detach(), trans=trans.detach(),
                rays=rays.detach(), cam_c=cam_c.detach())


def _newton_loop(nets, cfg: SurfaceConfig, init_pts, batch_inds, **det):
    """The Newton iterations on detached inputs (det: ``_detached``'s and
    the two ratios): (pts, converged, B at pts, the converged masks at each
    test (n_iters + 1, N)).  Without cfg.early_exit it reads nothing back
    to the host, so a CUDA graph can hold it whole."""
    pts = init_pts
    done = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    dones = []
    for _ in range(cfg.n_iters):
        if cfg.early_exit:
            trace.count("host_syncs")
            if bool(done.all()):
                break
        F, B, sdf, sin_ang = _constraint_and_B(nets, pts, batch_inds, **det)
        done = done | _converged(sdf, sin_ang, cfg)
        dones.append(done)
        btb = torch.einsum("nki,nkj->nij", B, B) + 1e-9 * eye
        inv, ok = inv3x3(btb, det_eps=1e-12)
        dp = -torch.einsum("nij,nkj,nk->ni", inv, B, F)
        nrm = torch.linalg.norm(dp, dim=-1, keepdim=True)
        dp = dp * torch.clamp(cfg.step_clip / nrm.clamp_min(1e-20), max=1.0)
        dp = torch.where((done | ~ok)[:, None], torch.zeros_like(dp), dp)
        pts = pts + dp
    F, B, sdf, sin_ang = _constraint_and_B(nets, pts, batch_inds, **det)
    done = done | _converged(sdf, sin_ang, cfg)
    return pts, done, B, torch.stack(dones + [done])


class _NewtonGraph:
    """``_newton_loop`` captured as one CUDA graph on static input buffers.
    The graph reads the nets' parameters and the skinner's tables where
    they are, so in-place updates (Adam, ``copy_``) reach it; its key in
    ``_GRAPHS`` holds their addresses, so new storage captures anew."""

    def __init__(self, nets, cfg: SurfaceConfig, inputs: dict):
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        # warm-up on a side stream: the autograd engine's device thread,
        # cuBLAS's handles and workspaces exist before the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _newton_loop(nets, cfg, **self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = _newton_loop(nets, cfg, **self.inputs)
        trace.count("solve_graph_captures")

    def replay(self, inputs: dict):
        """The loop's outputs on `inputs`, copied out of the graph's
        buffers."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)


# The captured solves, least recently used first.  A training run holds
# one per stage's shapes; the bound frees the graphs of nets gone by.
_GRAPHS: "OrderedDict[tuple, _NewtonGraph]" = OrderedDict()
_MAX_GRAPHS = 4


def _graph_key(nets, cfg: SurfaceConfig, inputs: dict) -> tuple:
    """What a captured loop depends on besides its input buffers' values:
    their shapes and dtypes (ray and frame counts), the device, the solve's
    constants, the switches that choose its kernels (TF32, deterministic
    algorithms), and the address and shape of every tensor the graph reads
    in place."""
    sdf_net, translator, skinner = nets
    read = [*sdf_net.parameters(), *translator.parameters(), skinner.ws,
            skinner.b_min, skinner.b_max]
    return (cfg, str(next(iter(inputs.values())).device),
            torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()),
            tuple((t.data_ptr(), tuple(t.shape)) for t in read))


def _newton(nets, cfg: SurfaceConfig, ratio_sdf, ratio_def, det, init_pts,
            batch_inds):
    """The Newton loop on detached inputs: (pts, converged, B at pts, the
    converged masks at each test).  The ratios enter as band weights on
    the device, so that a graph replays them."""
    sdf_net, translator, _ = nets
    dev = init_pts.device
    inputs = dict(init_pts=init_pts.detach(), batch_inds=batch_inds, **det,
                  ratio_sdf=band_weights(sdf_net.multires, ratio_sdf, dev),
                  ratio_def=band_weights(translator.multires, ratio_def,
                                         dev))
    if not (init_pts.is_cuda and not cfg.early_exit
            and torch.is_grad_enabled()):
        return _newton_loop(nets, cfg, **inputs)
    key = _graph_key(nets, cfg, inputs)
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        while len(_GRAPHS) >= _MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        graph = _NewtonGraph(nets, cfg, inputs)
    else:
        trace.count("solve_graph_replays")
    _GRAPHS[key] = graph
    return graph.replay(inputs)


def _cauchy(nets, cfg: SurfaceConfig, ratio_sdf, ratio_def, det, init_pts,
            batch_inds):
    """The reference's Cauchy loop on detached inputs (JAX surface.py:
    93-120): (pts, converged, the converged masks at each test).
    Convergence is tested at the start point and after every step; a
    converged point stays where it is.  One pass at each iterate gives both
    its convergence test and its gradient, so the loop evaluates the losses
    n_iters + 1 times where JAX's body evaluates them twice per iteration;
    the values are the same."""
    pts = init_pts.detach()
    dones = []
    for i in range(cfg.n_iters + 1):
        step = i < cfg.n_iters
        with torch.set_grad_enabled(step):
            p = pts.detach().requires_grad_(step)
            loss, sdf, sin_ang = _point_losses(nets, p, batch_inds,
                                               ratio_sdf=ratio_sdf,
                                               ratio_def=ratio_def, **det)
        now = _converged(sdf.detach(), sin_ang.detach(), cfg)
        dones.append(now if not dones else dones[-1] | now)
        if not step:
            break
        if cfg.early_exit:
            trace.count("host_syncs")
            if bool(dones[-1].all()):
                break
        (g,) = torch.autograd.grad(loss.sum(), p)
        t = -loss.detach() / (g * g).sum(-1).clamp_min(1e-20)
        pts = torch.where(dones[-1][:, None], pts, pts + t[:, None] * g)
    return pts, dones[-1], dones


def _solve(nets, cfg: SurfaceConfig, ratio_sdf, ratio_def, dcond, A, trans,
           rays, cam_c, init_pts, batch_inds):
    """The surface solve by the solver cfg names, without a gradient, at
    the poses' FK transforms A: (pts, converged, B at pts or None, the
    detached inputs).  Records the converged counts at each test
    (``solve_converged``)."""
    with trace.span("step.outer.solve"):
        det = _detached(dcond, A, trans, rays, cam_c)
        if cfg.newton:
            pts, done, B, dones = _newton(nets, cfg, ratio_sdf, ratio_def,
                                          det, init_pts, batch_inds)
        else:
            pts, done, dones = _cauchy(nets, cfg, ratio_sdf, ratio_def, det,
                                       init_pts, batch_inds)
            B = None
        trace.count("solve_converged", dones)
        return pts, done, B, det


def optimize_surface_points(nets, cfg: SurfaceConfig, ratio_sdf, ratio_def,
                            dcond, poses, trans, rays, cam_c, init_pts,
                            batch_inds):
    """The surface solve alone, without a gradient, by the solver cfg
    names: (pts (N,3), converged mask (N,))."""
    A = fk_transforms(nets[2], poses.detach())[0]
    return _solve(nets, cfg, ratio_sdf, ratio_def, dcond, A, trans, rays,
                  cam_c, init_pts, batch_inds)[:2]


def solve_surface(nets, cfg: SurfaceConfig, ratio_sdf, ratio_def, dcond, A,
                  trans, rays, cam_c, init_pts, batch_inds):
    """The surface solve without a gradient, at the poses' FK transforms A:
    (pts (N,3), converged mask (N,), B = dF/dp at pts (N,4,3)), what
    ``ift_points`` attaches the gradient with."""
    pts, done, B, det = _solve(nets, cfg, ratio_sdf, ratio_def, dcond, A,
                               trans, rays, cam_c, init_pts, batch_inds)
    if B is None:
        B = _constraint_and_B(nets, pts, batch_inds, ratio_sdf=ratio_sdf,
                              ratio_def=ratio_def, **det)[1]
    return pts, done, B


def ift_points(nets, ratio_sdf, ratio_def, dcond, A, trans, rays, cam_c,
               batch_inds, pts, done, B):
    """The solve's points (``solve_surface``: pts, done, B) carrying the
    IFT gradient w.r.t. the nets' parameters and dcond, A, trans, rays and
    cam_c."""
    # IFT: M = (B^T B)^-1 B^T at the solution, masked like the JAX backward
    btb_inv, inv_ok = inv3x3(torch.einsum("nki,nkj->nij", B, B))
    M = torch.einsum("nij,nkj->nik", btb_inv, B)                 # (N,3,4)
    keep = (done & inv_ok)[:, None, None]
    M = torch.where(keep, M, torch.zeros_like(M))

    sdf_net, translator, skinner = nets
    sdf_theta = sdf_net(pts, ratio_sdf)[0]
    d_theta, _ = deformer_apply_transforms(translator, skinner, pts,
                                           batch_inds, dcond, A, trans,
                                           ratio_def)
    Fc_theta, _, _ = _constraint(sdf_theta, d_theta, rays, cam_c)
    F_theta = torch.cat([sdf_theta[:, None], Fc_theta], dim=1)
    F_theta = torch.where(keep[:, :, 0], F_theta, torch.zeros_like(F_theta))
    corr = -torch.einsum("nik,nk->ni", M, F_theta)
    return pts + (corr - corr.detach())


def surface_points(nets, cfg: SurfaceConfig, ratio_sdf, ratio_def, dcond,
                   A, trans, rays, cam_c, init_pts, batch_inds):
    """nets = (sdf_net, translator, skinner), A (B,24,4,4) the poses' FK
    transforms of ``fk_transforms``: the solve reads A detached and the IFT
    correction A itself, so a caller that skins more points at these poses
    runs the FK once.  Returns (pts (N,3) carrying the IFT gradient,
    converged mask (N,))."""
    pts, done, B = solve_surface(nets, cfg, ratio_sdf, ratio_def, dcond, A,
                                 trans, rays, cam_c, init_pts, batch_inds)
    return ift_points(nets, ratio_sdf, ratio_def, dcond, A, trans, rays,
                      cam_c, batch_inds, pts, done, B), done


def surface_inits_from_fragments(tmp_verts, tmp_faces, pix_to_face, bary):
    """Per-pixel initial canonical points from rasterized fragments of the
    deformed template: the template point at the winner's barycentrics.
    Returns (init_pts (..., 3), valid (...,)), valid = a face was hit."""
    valid = pix_to_face >= 0
    tri = tmp_faces[pix_to_face.clamp_min(0).long()].long()    # (..., 3)
    return (tmp_verts[tri] * bary[..., :, None]).sum(-2), valid
