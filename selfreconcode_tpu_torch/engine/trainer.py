"""Per-subject avatar optimization: the training step and the trainer (torch
port of ``selfreconcode_tpu/engine/trainer.py``).

One step (``make_train_step``) is three passes:

  geom   (no grad) deform the template, seed one canonical point per pixel
         by the nearest projected vertex (scatter-min) or, with
         point_inits=False, by the rasterized fragments (the CUDA mesh
         kernel), dilate the GT mask, draw P rays inside it;
  inner  splat soft mask of the deformed template (the CUDA splat kernels),
         IoU, the mesh regularizers whose weight is > 0 (Laplacian, edge
         length, normal consistency) and deformation consistency; backward
         into the template verts (SGD with momentum 0.9, lr 0.05) and into
         the shared parameters;
  outer  surface points (Newton, or the reference's Cauchy step with
         surf_newton=False) with the IFT gradient, eikonal, deformation
         regularizer, DCT prior, colour and normal losses, SDF anchor;
         backward (on the card all after the solve is one CUDA graph),
         add to the inner gradients, mask frozen leaves, Adam.

The trainer builds the skinner, pretrains the SDF (IGR), remeshes (octree
sweep + marching cubes, then the template's edge topology) every
``remesh_intersect`` steps, runs the steps and dumps debug meshes and
renders (``save_debug``).
Everything is exact-size eager torch; nothing is padded to a capacity.
"""
from __future__ import annotations

import dataclasses
import os
import os.path as osp
import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.deformer import (deformer_apply, deformer_apply_transforms,
                               deformer_jacobian, point_jacobian)
from ..models.render import RenderNet
from ..models.sdf import SDFNet, sdf_grad, sdf_value_and_grad
from ..models.skinner import (Skinner, build_skinner, fk_transforms,
                              frame_rows, posed_skeleton,
                              skinner_apply_shared)
from ..models.translator import TranslatorNet
from ..ops.marching_cubes import marching_cubes
from .. import parallel as D
from ..ops.rasterize import rasterize_mesh, splat_mask
from ..ops.sparse_sdf import grid_world_coords, sparse_sdf_grid
from ..render.camera import (Camera, ang_threshold, cam_pos, make_camera,
                             transform_points_screen, view_rays)
from ..utils import meshops, to_device
from ..utils import trace
from ..utils.math import (dct_null_space, gm_robust, inv3x3,
                          log_singular_values_sq_sum, normalize, quat2mat)
from ..utils.pe import band_weights
from ..utils.sampling import sample_points, subsample_mask_topk
from . import losses as L
from .graphs import GraphCache
from .surface import (SurfaceConfig, ift_points, solve_surface,
                      surface_inits_from_fragments)

# ---------------------------------------------------------------------------
# Static stage configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LossWeights:
    """One loss_{stage} block of config.conf."""
    color_weight: float = 0.5
    normal_weight: float = 0.1
    weighted_normal: bool = True
    grad_weight: float = 1.0
    offset_weight: float = 0.0
    def_regu_weight: float = 0.1
    def_regu_c: float = 0.5
    dct_weight: float = 2.0
    pc_weight: float = 60.0
    pc_mask_weight: float = 1.0
    laplacian_weight: float = -10.0
    edge_weight: float = -10.0
    norm_weight: float = -0.001
    def_consistent_weight: float = 0.6
    def_consistent_c: float = 0.01
    sample_pix_num: int = 0  # 0 -> use train.sample_pix_num


@dataclass(frozen=True)
class StageStatic:
    name: str
    N: int                      # frames per step
    H: int
    W: int
    sample_pix: int             # rays per frame
    radius: float               # splat radius (NDC)
    remesh_intersect: int
    resolutions: Tuple[Tuple[int, int, int], ...]
    weights: LossWeights
    eik_tmp: int = 4096         # template-vert eikonal subsample
    anchor_sub: int = 16384     # sdf-anchor vertex subsample (0 = all)
    window: int = 30            # DCT temporal window
    opt_pose: bool = True
    opt_trans: bool = True
    opt_cam_focal: bool = True
    opt_cam_principal: bool = True
    opt_cam_quat: bool = False
    opt_cam_T: bool = True
    has_normals: bool = False
    surf_iters: int = 10
    surf_newton: bool = True    # False: the reference's Cauchy surface
                                # solve (utils/FindSurfacePs.py:114-163),
                                # an A/B variant (tools/ab_convergence.py)
    point_inits: bool = True    # ray seeds by vertex projection (False: by
                                # rasterized fragments, the reference's way)
    raster_footprint: int = 8   # picks the mesh raster cell (rasterize_mesh)

    def rays(self) -> int:
        per = (self.sample_pix if self.weights.sample_pix_num == 0
               else self.weights.sample_pix_num)
        return per * self.N


@dataclass
class Template:
    verts: torch.Tensor         # (nv, 3)
    faces: torch.Tensor         # (nf, 3)
    momentum: torch.Tensor      # (nv, 3) inner-SGD momentum
    topo: meshops.EdgeTopology  # edges of the faces (mesh regularizers)


def make_template(verts, faces, momentum=None) -> Template:
    """A template with its edge topology built from the faces (at every
    remesh and on checkpoint load); momentum defaults to zeros."""
    return Template(verts=verts, faces=faces,
                    momentum=(torch.zeros_like(verts) if momentum is None
                              else momentum),
                    topo=meshops.build_edge_topology(faces))


class AvatarNets(nn.Module):
    """The three MLPs under the reference's module names, so state_dict keys
    read sdf.lin{l}.*, deformer.defs.0.lin{l}.*, netRender.lin{l}.*."""

    def __init__(self, sdf: SDFNet, translator: TranslatorNet,
                 render: RenderNet):
        super().__init__()
        self.sdf = sdf
        self.deformer = nn.Module()
        self.deformer.defs = nn.ModuleList([translator])
        self.netRender = render

    @property
    def translator(self) -> TranslatorNet:
        return self.deformer.defs[0]


class StepDraws(NamedTuple):
    """Every random number one step uses (tests pass the JAX package's)."""
    sel_scores: torch.Tensor     # (N*H*W,) ray selection
    eik_scores: torch.Tensor     # (nv,) template-vert eikonal subsample
    eik_normal: torch.Tensor     # (S, 3) eikonal local jitter
    eik_uniform: torch.Tensor    # (S//6, 3) eikonal global samples
    def_normal: torch.Tensor     # (S, 3) def-regu jitter
    anchor_scores: Optional[torch.Tensor]  # (nv,) anchor subsample or None


def n_eik_tmp(cfg: StageStatic, nv: int) -> int:
    return min(cfg.eik_tmp, nv)


def draw_step_noise(cfg: StageStatic, nv: int, generator: torch.Generator,
                    device) -> StepDraws:
    S = cfg.rays() + n_eik_tmp(cfg, nv)
    kw = dict(generator=generator, device=device)
    return StepDraws(
        sel_scores=torch.rand(cfg.N * cfg.H * cfg.W, **kw),
        eik_scores=torch.rand(nv, **kw),
        eik_normal=torch.randn(S, 3, **kw),
        eik_uniform=torch.rand(S // 6, 3, **kw),
        def_normal=torch.randn(S, 3, **kw),
        anchor_scores=(torch.rand(nv, **kw)
                       if 0 < cfg.anchor_sub < nv else None))


# ---------------------------------------------------------------------------
# Camera plumbing
# ---------------------------------------------------------------------------

def camera_from_bank(bank, H: int, W: int, cfg: StageStatic) -> Camera:
    """The shared camera; frozen parameters enter detached."""
    def leaf(k, trainable):
        return bank[k] if trainable else bank[k].detach()
    R = quat2mat(leaf("cam2world_coord_quat", cfg.opt_cam_quat).reshape(1, 4))[0]
    return Camera(focal=leaf("focal_length", cfg.opt_cam_focal).reshape(2),
                  principal=leaf("princeple_points",
                                 cfg.opt_cam_principal).reshape(2),
                  R=R, T=leaf("world2cam_coord_trans",
                              cfg.opt_cam_T).reshape(3), H=H, W=W)


def grad_mask_tree(bank, cfg: StageStatic) -> Dict[str, bool]:
    """Which bank leaves are trainable (the nets always are)."""
    flags = {"poses": cfg.opt_pose, "trans": cfg.opt_trans,
             "focal_length": cfg.opt_cam_focal,
             "princeple_points": cfg.opt_cam_principal,
             "cam2world_coord_quat": cfg.opt_cam_quat,
             "world2cam_coord_trans": cfg.opt_cam_T}
    return {k: flags.get(k, True) for k in bank}


def image_batch(batch: dict, device) -> Tuple[torch.Tensor, ...]:
    """uint8 batch -> (colours in [-1,1] BGR, mask {0,1}, normals in [-1,1]
    or None) float32 on device."""
    img = to_device(batch["img"], device)
    mask = to_device(batch["mask"], device)
    if img.dtype == torch.uint8:
        img = (img.float() / 255.0 - 0.5) * 2.0
    if mask.dtype != torch.float32:
        mask = mask.float()
    nrm = batch.get("normal")
    if nrm is not None:
        nrm = to_device(nrm, device)
        if nrm.dtype == torch.uint8:
            nrm = 2.0 * nrm.float() / 255.0 - 1.0
    return img, mask, nrm


# ---------------------------------------------------------------------------
# Ray seeds of the geom pass
# ---------------------------------------------------------------------------

def point_seeds(cam: Camera, verts: torch.Tensor, def_verts: torch.Tensor):
    """Per frame of def_verts (N, nv, 3), the template vertex whose
    projection is the nearest at each pixel (a scatter-min of depth, then
    of vertex id).  Returns (seeds (N, H, W, 3), covered (N, H, W)).

    A vertex off the image or behind the camera scatters into one slot past
    the image's H * W, which is then dropped: no masked selection, so the
    host reads nothing."""
    H, W = cam.H, cam.W
    HW = H * W
    nv = verts.shape[0]
    dev = verts.device
    big = 3e38
    # an uncovered pixel seeds at the origin (JAX's padding vertex)
    seed = torch.cat([verts, verts.new_zeros(1, 3)])
    inits, covers = [], []
    for dv in def_verts:
        s = transform_points_screen(cam, dv)
        col = torch.round(s[:, 0]).long()
        row = torch.round(s[:, 1]).long()
        z = s[:, 2]
        ok = (z > 0.0) & (col >= 0) & (col < W) & (row >= 0) & (row < H)
        pix = row.clamp(0, H - 1) * W + col.clamp(0, W - 1)
        zimg = torch.full((HW + 1,), big, device=dev)
        zimg.scatter_reduce_(0, torch.where(ok, pix, HW), z, "amin")
        win = ok & (z <= zimg[pix])
        vid = torch.full((HW + 1,), nv, dtype=torch.long, device=dev)
        vid.scatter_reduce_(0, torch.where(win, pix, HW),
                            torch.arange(nv, device=dev), "amin")
        covers.append((zimg[:HW] < big).reshape(H, W))
        inits.append(seed[vid[:HW]].reshape(H, W, 3))
    return torch.stack(inits), torch.stack(covers)


def fragment_seeds(cam: Camera, verts: torch.Tensor, faces: torch.Tensor,
                   def_verts: torch.Tensor, footprint: int):
    """Per frame of def_verts (N, nv, 3), the template point at the
    barycentrics of the nearest rasterized face (reference FindSurfacePs
    semantics; one mesh-kernel launch per frame on the card).  Returns
    (seeds (N, H, W, 3), covered (N, H, W), face ids (N, H, W))."""
    frags = [rasterize_mesh(cam, dv, faces, footprint) for dv in def_verts]
    p2f = torch.stack([f.pix_to_face for f in frags])
    inits, covered = surface_inits_from_fragments(
        verts, faces, p2f, torch.stack([f.bary for f in frags]))
    return inits, covered, p2f


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

# The surface solve's CUDA graphs serve every step function of the process:
# a training run holds one per stage's shapes.
_SOLVE_CACHE = GraphCache("solve_graph", 4)


# every key a step's info may hold (the step sums their values over the
# ranks in this order)
STEP_INFO_KEYS = (
    "ray_converged", "grad_loss", "offset_loss", "def_loss", "dct_loss",
    "inv_ok", "color_loss", "normal_loss", "pc_loss_sdf", "pc_mask_loss",
    "pc_lap_loss", "pc_edge_loss", "pc_norm_loss", "pc_defconst_loss",
    "pred_mask_sum", "loss")


def make_train_step(nets: AvatarNets, skinner: Skinner, cfg: StageStatic,
                    dctnull: np.ndarray, ang_thresh_deg: float, optimizer):
    """Returns step(bank, tmp, gtCs, gtMs, gtNs, fids, windows, ratios, lr,
    draws) -> (new template, info dict of floats).

    Updates the nets and the bank in place (Adam); after the call each leaf's
    .grad holds the masked inner + outer gradient the update used.

    Under a data-parallel group (``parallel.init_dp``; every rank passes the
    same arguments) rank 0 alone runs the geom and inner passes, the DCT
    prior and the SDF anchor, and broadcasts the rays and the new template;
    each rank runs the outer pass's per-ray work on its contiguous share of
    the rays and its point terms on its share of the points (each mean is
    its share's part of the global mean; the per-frame counts are summed
    over ranks first).  One all-reduce then sums the gradients and the info
    values, and every rank takes the same Adam step.  Without a group every
    collective is a no-op and each share is the whole.

    The outer pass is a prelude and a body (``outer_prelude``,
    ``outer_terms`` and its backward): the prelude solves for the surface
    points and takes what a remesh resizes; the body reads only device
    tensors of fixed shapes.  ``graph_caches`` alone decides what replays
    as a CUDA graph (``graphs.GraphCache``), captured at the step
    function's first step and replayed at every later one: on the card the
    solve's Newton loop, and without a process group the body.

    The geom pass, the inner pass (its deform and the consistency term)
    and the DCT windows each run the poses' forward kinematics once; the
    outer pass twice, detached for the solve and with its graph for the
    IFT correction and the Jacobian.  Past the first step the host waits
    for the device only at the readback: the ray seeds and the splat's
    binning have sizes the host knows (with ``point_inits``; fragment seeds
    bin the mesh to its exact size, which reads the device)."""
    surf_cfg = SurfaceConfig(n_iters=cfg.surf_iters,
                             athreshold_deg=ang_thresh_deg,
                             newton=cfg.surf_newton)
    w = cfg.weights
    N, H, W = cfg.N, cfg.H, cfg.W
    P = cfg.rays()
    radius_px = int(np.round(cfg.radius / 2.0 * float(min(H, W)) / 1.2))
    sdf_net, translator, render_net = nets.sdf, nets.translator, nets.netRender
    surf_nets = (sdf_net, translator, skinner)
    skinner_tensors = [getattr(skinner, f.name)
                       for f in dataclasses.fields(skinner)
                       if torch.is_tensor(getattr(skinner, f.name))]
    dctnull_dev = to_device(dctnull, skinner.joints.device)
    # the update's flags, learnt at the first step: "grad" and "present"
    # (agreed over ranks) and this rank's own info keys, "keys"
    agreed = {}
    # the body's graphs: one while the stage's shapes and storage hold (the
    # stage's configuration is this step function's own)
    body_graphs = GraphCache("outer_graph", 2)

    def graph_caches(dev):
        """The caches the step replays through on `dev`, (the solve's, the
        outer body's); None runs that part eagerly, as on the CPU.  Under a
        process group (of any size) the body all-reduces and gathers rows,
        which reads counts back to the host: it runs eagerly there."""
        if dev.type != "cuda":
            return None, None
        return _SOLVE_CACHE, None if dist.is_initialized() else body_graphs

    def frame_params(bank, fids):
        poses, trans = bank["poses"][fids], bank["trans"][fids]
        if not cfg.opt_pose:
            poses = poses.detach()
        if not cfg.opt_trans:
            trans = trans.detach()
        return poses, trans, bank["dcond"][fids], bank["rcond"][fids]

    def geom_pass(bank, tmp, gtMs, fids, r_def, draws):
        with trace.span("step.geom"), torch.no_grad():
            cam = camera_from_bank(bank, H, W, cfg)
            poses, trans, dcond, _ = frame_params(bank, fids)
            nv = tmp.verts.shape[0]
            binds = torch.arange(N, device=tmp.verts.device).repeat_interleave(
                nv)
            def_verts = deformer_apply(translator, skinner, tmp.verts.repeat(N, 1),
                                       binds, dcond, poses, trans,
                                       r_def)[0].reshape(N, nv, 3)
            if cfg.point_inits:
                inits, covers = point_seeds(cam, tmp.verts, def_verts)
            else:
                inits, covers, _ = fragment_seeds(cam, tmp.verts, tmp.faces,
                                                  def_verts,
                                                  cfg.raster_footprint)
            mgtMs = L.max_pool_mask(gtMs, radius_px)
            sel = covers & (gtMs > 0.0)
            idx, sel_ok = subsample_mask_topk(sel.reshape(-1), P,
                                              scores=draws.sel_scores)
            return inits.reshape(-1, 3)[idx], sel_ok, idx, mgtMs

    def inner_pass(bank, tmp, fids, mgtMs, r_def):
        with trace.span("step.inner"):
            tv = tmp.verts.detach().requires_grad_(True)
            nv = tv.shape[0]
            cam = camera_from_bank(bank, H, W, cfg)
            poses, trans, dcond, _ = frame_params(bank, fids)
            binds = torch.arange(N, device=tv.device).repeat_interleave(nv)
            # one FK for the deform and the consistency term
            A = fk_transforms(skinner, poses)[0]
            def_verts = deformer_apply_transforms(
                translator, skinner, tv.repeat(N, 1), binds, dcond, A, trans,
                r_def)[0].reshape(N, nv, 3)
            valid = torch.ones(nv, dtype=torch.bool, device=tv.device)
            masks = torch.stack([splat_mask(cam, def_verts[i], valid,
                                            cfg.radius) for i in range(N)])
            mask_loss = L.iou_mask_loss(masks, mgtMs)
            loss = mask_loss * w.pc_mask_weight
            info = {"pc_mask_loss": mask_loss.detach()}
            if w.laplacian_weight > 0.0:
                lap = meshops.uniform_laplacian_loss(tv, tmp.topo.edges)
                loss = loss + w.laplacian_weight * lap
                info["pc_lap_loss"] = lap.detach()
            if w.edge_weight > 0.0:
                el = meshops.edge_length_loss(tv, tmp.topo.edges)
                loss = loss + w.edge_weight * el
                info["pc_edge_loss"] = el.detach()
            if w.norm_weight > 0.0:
                nc = meshops.normal_consistency_loss(tv, tmp.faces, tmp.topo)
                loss = loss + w.norm_weight * nc
                info["pc_norm_loss"] = nc.detach()
            if w.def_consistent_weight > 0.0:
                lbs_b = skinner_apply_shared(skinner, tv, A, trans)
                dc = L.def_consistency_loss(def_verts, lbs_b, valid,
                                            w.def_consistent_c)
                loss = loss + w.def_consistent_weight * dc
                info["pc_defconst_loss"] = dc.detach()
            loss.backward()
            # torch SGD(momentum=0.9, lr=0.05): buf = 0.9*buf + g;
            # v -= lr*buf
            with torch.no_grad():
                mom = 0.9 * tmp.momentum + tv.grad
                new_tmp = dataclasses.replace(
                    tmp, verts=tmp.verts - 0.05 * mom, momentum=mom)
            info["pred_mask_sum"] = masks.detach().sum()
            return new_tmp, loss.detach(), info

    def share_mean(v, n_all: int):
        """v.mean() over this rank's rows, as its part of the mean over
        all n_all rows (the ranks' parts sum to it; at a world of one the
        factor is 1.0 exactly)."""
        return v.mean() * (v.shape[0] / n_all)

    def gt_normals(cam, gtNs, ray_binds, ray_rows, ray_cols):
        """The rays' GT normals in world space, unit length, and where they
        are valid (a map's zero normal is not)."""
        gtn = gtNs[ray_binds, ray_rows, ray_cols]
        # cam.R @ diag(-1, 1, -1): the maps' x and z axes point the other way
        R = cam.R
        gtn_w = torch.einsum("ij,nj->ni",
                             torch.stack([-R[:, 0], R[:, 1], -R[:, 2]], 1),
                             gtn)
        norms = torch.linalg.norm(gtn_w, dim=-1, keepdim=True)
        return gtn_w / norms.clamp_min(1e-4), norms[..., 0] > 1e-4

    def pixels(ray_rows, ray_cols):
        """The rays' pixel coordinates (column, row, 1)."""
        return torch.stack([ray_cols.float(), ray_rows.float(),
                            torch.ones(ray_rows.shape[0],
                                       device=ray_rows.device)], dim=-1)

    def outer_prelude(bank, new_tmp, gtCs, gtNs, fids, init_pts, sel_ok,
                      ray_rows, ray_cols, ray_binds, windows, ratios, draws):
        """The outer pass up to its loss terms, without a gradient: the
        surface solve at the camera and the poses' FK, both detached (its
        own span, and its graph where ``graph_caches`` gives one), the
        template's two subsamples (sized by the template, which a remesh
        resizes) and the
        ratios' band weights.  Returns ``outer_terms``' inputs: device
        tensors only, whose shapes a remesh leaves as they are while the
        template has more than cfg.anchor_sub vertices."""
        dev = init_pts.device
        w_sdf, w_def, w_ren = (band_weights(m, r, dev) for m, r in zip(
            (sdf_net.multires, translator.multires, render_net.multires_v),
            ratios))
        with torch.no_grad():
            cam = camera_from_bank(bank, H, W, cfg)
            poses, trans, dcond, _ = frame_params(bank, fids)
            rays = view_rays(cam, pixels(ray_rows, ray_cols))
            A = fk_transforms(skinner, poses)[0]
            new_verts = new_tmp.verts.detach()
            nv = new_verts.shape[0]
            valid_v = torch.ones(nv, dtype=torch.bool, device=dev)
            tidx, _ = subsample_mask_topk(valid_v, n_eik_tmp(cfg, nv),
                                          scores=draws.eik_scores)
            if draws.anchor_scores is not None:
                aidx, avalid = subsample_mask_topk(
                    valid_v, cfg.anchor_sub, scores=draws.anchor_scores)
                averts = new_verts[aidx]
            else:
                averts, avalid = new_verts, valid_v
        pts, done, B = solve_surface(surf_nets, surf_cfg, w_sdf, w_def,
                                     dcond, A, trans, rays, cam_pos(cam),
                                     init_pts, ray_binds,
                                     graph_caches(dev)[0])
        return dict(gtCs=gtCs, gtNs=gtNs, fids=fids, windows=windows,
                    sel_ok=sel_ok, ray_rows=ray_rows, ray_cols=ray_cols,
                    ray_binds=ray_binds, pts=pts, done=done, B=B,
                    eik_verts=new_verts[tidx], anchor_verts=averts,
                    anchor_valid=avalid, eik_normal=draws.eik_normal,
                    eik_uniform=draws.eik_uniform,
                    def_normal=draws.def_normal, w_sdf=w_sdf, w_def=w_def,
                    w_ren=w_ren)

    def outer_terms(bank, x):
        """The outer pass's loss terms on ``outer_prelude``'s inputs x:
        (total loss with its graph, info).  It reads x's tensors and the
        leaves, and no number that changes from step to step, so a CUDA
        graph replays it.  The rays (and the point terms' points) are this
        rank's share."""
        r_sdf, r_def, r_ren = x["w_sdf"], x["w_def"], x["w_ren"]
        ray_rows, ray_cols = x["ray_rows"], x["ray_cols"]
        ray_binds = x["ray_binds"]
        cam = camera_from_bank(bank, H, W, cfg)
        poses, trans, dcond, _ = frame_params(bank, x["fids"])
        n_rays = ray_rows.shape[0]
        info = {}
        rays = view_rays(cam, pixels(ray_rows, ray_cols))
        # one FK for the IFT correction and the Jacobian
        A = fk_transforms(skinner, poses)[0]
        pts = ift_points(surf_nets, r_sdf, r_def, dcond, A, trans, rays,
                         cam_pos(cam), ray_binds, x["pts"], x["done"],
                         x["B"])
        done = x["done"] & x["sel_ok"]
        info["ray_converged"] = done.sum()
        use_normals = cfg.has_normals and w.normal_weight > 0.0
        if use_normals:
            gtn_w, nok = gt_normals(cam, x["gtNs"], ray_binds, ray_rows,
                                    ray_cols)
        else:
            nok = torch.zeros_like(done)
        # the per-frame ray counts of every rank, before any loss
        with torch.no_grad():
            cnt_c = L.frame_counts(ray_binds, done, N)
            cnt_n = L.frame_counts(ray_binds, nok & done, N)
            D.allreduce_sum_([cnt_c, cnt_n])

        base = torch.cat([D.all_gather_rows(pts.detach()), x["eik_verts"]],
                         dim=0)
        nonmnfld = sample_points(base, 1.8, 0.01,
                                 noise=(x["eik_normal"], x["eik_uniform"]))
        n_eik = nonmnfld.shape[0]
        nonmnfld = D.share(nonmnfld)
        g_eik = sdf_grad(sdf_net, nonmnfld, r_sdf)
        grad_loss = share_mean((torch.linalg.norm(g_eik, dim=-1) - 1.0) ** 2,
                               n_eik)
        info["grad_loss"] = grad_loss
        total = grad_loss * w.grad_weight

        if w.offset_weight > 0.0:
            M = nonmnfld.shape[0]
            bn = torch.arange(N, device=pts.device).repeat_interleave(M)
            off = translator.offset(nonmnfld.repeat(N, 1),
                                    frame_rows(dcond, bn), r_def)
            off_l = share_mean(torch.linalg.norm(off, dim=-1), N * n_eik)
            info["offset_loss"] = off_l
            total = total + off_l * w.offset_weight

        if w.def_regu_weight > 0.0:
            jit_pts = sample_points(base, 1.8, 0.01, ratio=0,
                                    noise=(x["def_normal"],))
            dr_pts = torch.cat([base, jit_pts], dim=0)
            n_dr = dr_pts.shape[0]
            dr_pts = D.share(dr_pts)
            M = dr_pts.shape[0]
            bd = torch.arange(N, device=pts.device).repeat_interleave(M)
            conds = frame_rows(dcond, bd)
            jac, _ = point_jacobian(
                lambda q: translator(q, conds, r_def)[0], dr_pts.repeat(N, 1))
            s2 = log_singular_values_sq_sum(jac)
            def_loss = share_mean(gm_robust(s2, w.def_regu_c, square=True),
                                  N * n_dr)
            info["def_loss"] = def_loss
            total = total + def_loss * w.def_regu_weight

        main = D.is_main()
        if main and (cfg.opt_pose or cfg.opt_trans) and w.dct_weight > 0.0:
            wposes = bank["poses"][x["windows"]]
            if not cfg.opt_pose:
                wposes = wposes.detach()
            Nw = x["windows"].shape[1]
            pj = posed_skeleton(skinner, wposes.reshape(N * Nw, 24, 3))
            dct_loss = L.dct_prior_loss(dctnull_dev, pj.reshape(N, Nw, 24, 3))
            info["dct_loss"] = dct_loss
            total = total + dct_loss * w.dct_weight

        _, g_pts, feat = sdf_value_and_grad(sdf_net, pts, r_sdf)
        nx = normalize(g_pts)
        jac_d, _ = deformer_jacobian(translator, skinner, pts, ray_binds,
                                     dcond, A, trans, r_def)
        jinv, inv_ok = inv3x3(jac_d)
        info["inv_ok"] = inv_ok.sum()
        crays = torch.einsum("nij,nj->ni", jinv, rays)
        crays = normalize(torch.where(inv_ok[:, None], crays, rays))

        if w.color_weight > 0.0:
            colors = render_net(pts, nx, crays, feat, r_ren)
            gt = x["gtCs"][ray_binds, ray_rows, ray_cols]
            color_loss = L.color_l1_loss(colors, gt, ray_binds, done, cnt_c)
            info["color_loss"] = color_loss
            total = total + w.color_weight * color_loss

        if use_normals:
            with torch.no_grad():
                ndef = torch.einsum("nji,nj->ni", jinv, nx)     # J^-T n
                ndef = torch.where(inv_ok[:, None], ndef,
                                   torch.einsum("nij,nj->ni", jac_d, nx))
                ndef = normalize(ndef)
                if w.weighted_normal:
                    wgt = ((-rays * ndef).sum(-1)).clamp(0.0, 1.0) ** 2
                else:
                    wgt = torch.ones(n_rays, device=pts.device)
            gtn_c = torch.einsum("nji,nj->ni", jac_d, gtn_w)   # J^T n_gt
            normal_loss = L.normal_loss(gtn_c, nx, wgt, ray_binds,
                                        nok & done, cnt_n)
            info["normal_loss"] = normal_loss
            total = total + w.normal_weight * normal_loss

        if main:
            anchor = L.sdf_anchor_loss(sdf_net(x["anchor_verts"], r_sdf)[0],
                                       x["anchor_valid"], 0.0)
            info["pc_loss_sdf"] = anchor
            total = total + anchor * w.pc_weight
        return total, info

    def outer_loss(*args):
        """The outer pass's forward: (total loss with its graph, info)."""
        return outer_terms(args[0], outer_prelude(*args))

    def outer_body(bank, x):
        """``outer_terms``, then its backward into the leaves' .grad:
        (total, info), detached."""
        total, info = outer_terms(bank, x)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in info.items()}

    def outer_pass(*args):
        """The outer pass and its backward into the leaves' .grad: the
        prelude, then the body, a replay of its CUDA graph where
        ``graph_caches`` gives one."""
        bank = args[0]
        with trace.span("step.outer"):
            x = outer_prelude(*args)
            graphs = graph_caches(x["pts"].device)[1]
            if graphs is None:
                return outer_body(bank, x)
            # every tensor whose .grad the body may add to, once
            leaves = dict.fromkeys([p for g in optimizer.param_groups
                                    for p in g["params"]] + [*bank.values()])
            return graphs.replay(lambda xs: outer_body(bank, xs), x,
                                 reads=[*skinner_tensors, dctnull_dev],
                                 leaves=list(leaves))

    def ray_pixels(idx):
        """(frame, row, column) of each selected pixel id."""
        rem = idx % (H * W)
        return idx // (H * W), rem // W, rem % W

    def step(bank, tmp: Template, gtCs, gtMs, gtNs, fids, windows, ratios,
             lr: float, draws: StepDraws):
        optimizer.zero_grad(set_to_none=False)
        r_def = ratios[1]
        dev = tmp.verts.device
        if D.is_main():
            init_pts, sel_ok, idx, mgtMs = geom_pass(bank, tmp, gtMs, fids,
                                                     r_def, draws)
            new_tmp, pc_loss, info = inner_pass(bank, tmp, fids, mgtMs, r_def)
        else:
            init_pts = torch.empty(P, 3, device=dev)
            sel_ok = torch.empty(P, dtype=torch.bool, device=dev)
            idx = torch.empty(P, dtype=torch.long, device=dev)
            new_tmp = dataclasses.replace(
                tmp, verts=torch.empty_like(tmp.verts),
                momentum=torch.empty_like(tmp.momentum))
            pc_loss, info = 0.0, {}
        D.broadcast_([init_pts, sel_ok, idx, new_tmp.verts,
                      new_tmp.momentum])
        ray_binds, ray_rows, ray_cols = ray_pixels(idx)
        outer, outer_info = outer_pass(
            bank, new_tmp, gtCs, gtNs, fids, D.share(init_pts),
            D.share(sel_ok), D.share(ray_rows), D.share(ray_cols),
            D.share(ray_binds), windows, ratios, draws)
        info = {**outer_info, **info, "loss": outer + pc_loss}
        unknown = set(info) - set(STEP_INFO_KEYS)
        if unknown:
            raise KeyError(f"info keys outside STEP_INFO_KEYS: {unknown}")
        with trace.span("step.update"):
            # one all-reduce: the gradients and the info values, and at the
            # step function's first step which leaves have a gradient and
            # which keys are set on some rank (read back once: both are
            # fixed for the step function)
            leaves = [p for g in optimizer.param_groups for p in g["params"]]
            local = [p.grad is not None for p in leaves]
            grads = [p.grad if h else torch.zeros_like(p)
                     for p, h in zip(leaves, local)]
            zero = torch.zeros((), device=dev)
            vals = torch.stack([info[k].float() if k in info else zero
                                for k in STEP_INFO_KEYS])
            if not agreed:
                agreed["keys"] = set(info)
                flags = to_device(torch.tensor(
                    [float(h) for h in local]
                    + [float(k in info) for k in STEP_INFO_KEYS]), dev)
                D.allreduce_sum_(grads + [vals, flags])
                trace.count("host_syncs")
                f = flags.tolist()
                agreed["grad"] = [n > 0 for n in f[:len(leaves)]]
                agreed["present"] = [n > 0 for n in f[len(leaves):]]
            else:
                # a step that breaks what the first step learnt raises on
                # this rank alone, before the all-reduce: under data
                # parallelism the other ranks then wait in it until the
                # process group's timeout
                if any(h and not a for h, a in zip(local, agreed["grad"])):
                    raise RuntimeError("a leaf has a gradient that it had on "
                                       "no rank at the step function's "
                                       "first step")
                if set(info) != agreed["keys"]:
                    raise RuntimeError(
                        f"info keys {sorted(set(info) ^ agreed['keys'])} "
                        f"differ from the step function's first step")
                D.allreduce_sum_(grads + [vals])
            for p, g, a in zip(leaves, grads, agreed["grad"]):
                if a and p.grad is None:
                    p.grad = g
            with torch.no_grad():
                for k, trainable in grad_mask_tree(bank, cfg).items():
                    if not trainable and bank[k].grad is not None:
                        bank[k].grad.zero_()
            for group in optimizer.param_groups:
                group["lr"] = float(lr)
            optimizer.step()
            # the readback, with the device counters of the step (if any)
            trace.count("host_syncs")
            out = {k: v for k, v, n in zip(STEP_INFO_KEYS, trace.tolist(vals),
                                           agreed["present"]) if n}
        return new_tmp, out

    # the passes, for diagnostics (tools/profile_step.py, bench_outer.py):
    # inner_pass and outer_pass add to the leaves' .grad, so a caller that
    # repeats them zeroes the gradients between calls
    step.geom_pass = geom_pass
    step.inner_pass = inner_pass
    step.outer_loss = outer_loss
    step.outer_prelude = outer_prelude
    step.outer_body = outer_body
    step.outer_pass = outer_pass
    step.ray_pixels = ray_pixels
    step.graph_caches = graph_caches
    return step


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------

class Trainer:
    """Skinner, SDF pretraining, remeshing, stage switching, steps."""

    def __init__(self, dataset, smpl_model, conf, resolutions: Dict[str, list],
                 seed: int = 0,
                 skinner_res=(129, 225, 65), data_root: Optional[str] = None,
                 device="cuda"):
        from ..models.smpl import smpl_tmp_apose
        self.device = torch.device(device)
        self.dataset = dataset
        self.conf = conf
        self.resolutions = resolutions
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.timings = {"skinner": 0.0, "igr": 0.0, "remesh": 0.0,
                        "steps": []}
        self.history = []

        sdf = SDFNet(multires=conf.get_int("sdf_net.multires"),
                     seed=3 * seed + 1)
        translator = TranslatorNet(
            cond_size=conf.get_int("mlp_deformer.condlen"),
            multires=conf.get_int("mlp_deformer.multires"), seed=3 * seed + 2)
        render = RenderNet(feature_size=conf.get_int("render_net.condlen"),
                           multires_v=conf.get_int("render_net.multires_v"),
                           seed=3 * seed + 3)
        self.nets = AvatarNets(sdf, translator, render).to(self.device)

        pose_type = conf.get_int("train.skinner_pose_type")
        cache = (osp.join(data_root, f"initial_skinner_{pose_type}_torch.pt")
                 if data_root else None)
        t0 = time.perf_counter()
        self.skinner, self.body_vs, self.body_fs = self._build_or_load_skinner(
            smpl_model, dataset.shape, smpl_tmp_apose(pose_type), skinner_res,
            cache)
        self._sync()
        self.timings["skinner"] = time.perf_counter() - t0
        self.b_min = self.skinner.b_min.cpu().numpy().copy()
        self.b_max = self.skinner.b_max.cpu().numpy().copy()

        self.bank = {k: torch.tensor(v, device=self.device, requires_grad=True)
                     for k, v in dataset.param_bank().items()}
        self.optimizer = self._make_optimizer()
        self.tmp: Optional[Template] = None
        self.stage_cfg: Optional[StageStatic] = None
        self._step_fn = None
        self.opt_times = 0
        self.forward_time = 0
        self.remesh_time = 0.0
        self._warned_boundary = False
        self._bbox_grow_left = None
        nw = min(30, dataset.frame_num - 1)
        self.window = nw
        self.dctnull = dct_null_space(min(10, max(1, nw // 3)), nw)
        self.ang_thresh = ang_threshold(self.camera(), 0.5)

    # -- helpers ------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _make_optimizer(self):
        return torch.optim.Adam(
            list(self.nets.parameters()) + list(self.bank.values()),
            lr=1.0, betas=(0.9, 0.999), eps=1e-8)

    def camera(self) -> Camera:
        """The current camera (detached), for host-side use."""
        b = self.bank
        return make_camera(b["focal_length"].detach(),
                           b["princeple_points"].detach(),
                           b["cam2world_coord_quat"].detach(),
                           b["world2cam_coord_trans"].detach(),
                           self.dataset.H, self.dataset.W, device=self.device)

    def rays_per_step(self) -> int:
        return self.stage_cfg.rays()

    def _build_or_load_skinner(self, smpl_model, shape, init_pose, res, cache):
        if cache and osp.isfile(cache):
            z = torch.load(cache, map_location=self.device)
            sk = Skinner(ws=z["ws"], ws_dims=tuple(z["ws_dims"]),
                         b_min=z["b_min"], b_max=z["b_max"],
                         joints=z["joints"], init_pose_inv=z["init_pose_inv"],
                         parents=tuple(z["parents"]))
            return sk, z["body_vs"], z["body_fs"].cpu().numpy()
        sk, vs, fs = build_skinner(smpl_model, shape, init_pose,
                                   resolution=res, device=self.device)
        if cache:
            torch.save({**dataclasses.asdict(sk), "body_vs": vs,
                        "body_fs": torch.as_tensor(fs)}, cache)
        return sk, vs, fs

    def deformed_template(self, fids) -> torch.Tensor:
        """(N, nv, 3) template deformed into frames `fids`."""
        fids = torch.as_tensor(np.asarray(fids), device=self.device)
        N, nv = len(fids), self.tmp.verts.shape[0]
        binds = torch.arange(N, device=self.device).repeat_interleave(nv)
        ratio = self.opt_times / 2500.0 + 0.5
        out, _ = deformer_apply(self.nets.translator, self.skinner,
                                self.tmp.verts.repeat(N, 1), binds,
                                self.bank["dcond"][fids],
                                self.bank["poses"][fids],
                                self.bank["trans"][fids], ratio)
        return out.reshape(N, nv, 3)

    # -- SDF initialization ---------------------------------------------------
    def initialize_sdf(self, n_iters: int, cache_path: Optional[str] = None):
        """IGR pretraining to the A-pose body cloud (cached)."""
        from .igr_init import igr_pretrain
        sdf = self.nets.sdf
        if cache_path and osp.isfile(cache_path):
            sdf.load_state_dict(torch.load(cache_path,
                                           map_location=self.device))
            return {"cached": True}
        t0 = time.perf_counter()
        vs = torch.as_tensor(self.body_vs, device=self.device)
        fs = torch.as_tensor(self.body_fs, device=self.device).long()
        info = igr_pretrain(sdf, vs, meshops.vertex_normals(vs, fs),
                            n_iters=n_iters, generator=self.generator)
        self._sync()
        self.timings["igr"] = time.perf_counter() - t0
        self.optimizer = self._make_optimizer()   # no moments from pretraining
        self._step_fn = None
        if cache_path:
            torch.save(sdf.state_dict(), cache_path)
        return info

    # -- remesh -------------------------------------------------------------
    def _query_fn(self, ratio: float, chunk: int = 65536):
        sdf = self.nets.sdf

        def q(p):
            return torch.cat([sdf(c, ratio)[0] for c in torch.split(p, chunk)])
        return q

    def _grow_left(self) -> np.ndarray:
        """The bbox growth each side has left (x-, y-, z-, x+, y+, z+): half
        the initial extent over the run's lifetime."""
        if self._bbox_grow_left is None:
            ext0 = (self.b_max - self.b_min).astype(np.float64)
            self._bbox_grow_left = np.concatenate([0.5 * ext0, 0.5 * ext0])
        return self._bbox_grow_left

    def discretize_sdf(self, ratio_sdf: float, resolutions=None):
        """Octree sweep + marching cubes with the directional bbox growth;
        returns the MCResult (exact-size verts/faces)."""
        res = resolutions or self.stage_cfg.resolutions
        res = tuple(tuple(int(v) for v in r) for r in res)
        grow_left = self._grow_left()
        for tries in range(4):
            with torch.no_grad():
                with trace.span("remesh.sweep"):
                    vol = sparse_sdf_grid(self._query_fn(ratio_sdf), res,
                                          self.b_min, self.b_max, 0.0,
                                          device=self.device)
                with trace.span("remesh.mc"):
                    spacing, origin = grid_world_coords(
                        res[-1], self.b_min, self.b_max, self.device)
                    mc = marching_cubes(vol, origin, spacing, 0.0)
            nv = mc.verts.shape[0]
            sides = mc.boundary_sides.copy()
            if mc.n_boundary > 0 and not sides.any():
                # ownerless crossings live on the max faces: grow the hi sides
                sides[[1, 3, 5]] = 1
            sides = np.where(grow_left[[0, 3, 1, 4, 2, 5]] > 0, sides, 0)
            if not (sides.any() and nv > 0 and tries < 3):
                break
            # the surface is clipped by a bbox face: grow only those sides by
            # 8% of the extent, within a lifetime budget of 50% per side
            ext = self.b_max - self.b_min
            lo_amt = np.where(sides[[0, 2, 4]] > 0,
                              np.minimum(0.08 * ext, grow_left[:3]), 0.0)
            hi_amt = np.where(sides[[1, 3, 5]] > 0,
                              np.minimum(0.08 * ext, grow_left[3:]), 0.0)
            self.b_min = (self.b_min - lo_amt).astype(np.float32)
            self.b_max = (self.b_max + hi_amt).astype(np.float32)
            grow_left[:3] -= lo_amt
            grow_left[3:] -= hi_amt
            # bigger voxels, bigger projected triangles: widen the stage's
            # raster cells if the footprint grew
            if self.stage_cfg is not None:
                fp = self._stage_footprint(self.stage_cfg.resolutions)
                if fp > self.stage_cfg.raster_footprint:
                    self.override_stage(raster_footprint=fp)
            print(f"growing sweep bbox 8% on clipped sides (attempt "
                  f"{tries + 1}): plane inside-counts (x-,x+,y-,y+,z-,z+)="
                  f"{sides.tolist()}, {mc.n_boundary} ownerless crossings",
                  flush=True)
        if nv == 0:
            raise RuntimeError("the template SDF has no zero level set")
        if (mc.n_boundary > 0 or sides.any()) and not self._warned_boundary:
            print(f"WARNING: surface touches the sweep bbox after growth "
                  f"({mc.n_boundary} ownerless crossings, plane inside-counts "
                  f"{sides.tolist()})", flush=True)
            self._warned_boundary = True
        return mc

    def remesh(self, ratio_sdf: float):
        with trace.span("remesh") as sp:
            verts, faces = self._remesh_on_main(ratio_sdf)
            self.tmp = make_template(verts, faces)
            self._sync()
        self.timings["remesh"] = sp.seconds
        self.remesh_time = 1.0 + np.floor(self.remesh_time)
        return verts.shape[0], faces.shape[0]

    def _host_state(self) -> torch.Tensor:
        """What a remesh may change on the host: the sweep bbox, its growth
        budget, the raster footprint and the boundary warning."""
        fp = self.stage_cfg.raster_footprint if self.stage_cfg else 0
        trace.count("host_syncs")
        return torch.tensor(np.concatenate([
            self.b_min, self.b_max, self._grow_left(),
            [fp, float(self._warned_boundary)]]), dtype=torch.float64,
            device=self.device)

    def _remesh_on_main(self, ratio_sdf: float):
        """Rank 0 remeshes; every rank receives its verts, faces and host
        state (without a group, the broadcasts are no-ops)."""
        dev = self.device
        if D.is_main():
            mc = self.discretize_sdf(ratio_sdf)
            verts, faces = mc.verts, mc.faces
            trace.count("host_syncs")
            sizes = torch.tensor([verts.shape[0], faces.shape[0]],
                                 device=dev)
        else:
            sizes = torch.zeros(2, dtype=torch.long, device=dev)
        D.broadcast_([sizes])
        if not D.is_main():
            trace.count("host_syncs")
            nv, nf = sizes.tolist()
            verts = torch.empty(nv, 3, device=dev)
            faces = torch.empty(nf, 3, dtype=torch.long, device=dev)
        host = self._host_state()
        D.broadcast_([verts, faces, host])
        trace.count("host_syncs")
        h = host.cpu().numpy()
        self.b_min = h[0:3].astype(self.b_min.dtype)
        self.b_max = h[3:6].astype(self.b_max.dtype)
        self._bbox_grow_left = h[6:12].copy()
        self._warned_boundary = bool(h[13])
        if self.stage_cfg and int(h[12]) != self.stage_cfg.raster_footprint:
            self.override_stage(raster_footprint=int(h[12]))
        return verts, faces

    def set_dp(self):
        """Train as one rank of the data-parallel group that
        ``parallel.init_dp`` joined (the counterpart of JAX's
        ``set_mesh``): rank 0's nets, bank, template, Adam state and
        generator state overwrite every rank's; each step then shards its
        rays over the ranks and rank 0 alone remeshes.  Every rank must call
        it after the same set-up (the same checkpoint, stage and template
        shapes)."""
        state = list(self.nets.state_dict().values()) + list(
            self.bank.values())
        if self.tmp is not None:
            state += [self.tmp.verts, self.tmp.faces, self.tmp.momentum]
        for st in self.optimizer.state.values():
            state += [v for v in st.values() if torch.is_tensor(v)]
        gen = self.generator.get_state()
        state.append(gen)
        layout = torch.tensor([len(state), sum(t.numel() for t in state)],
                              device=self.device)
        mine = layout.clone()
        D.broadcast_([layout])
        if not torch.equal(layout, mine):
            raise RuntimeError(f"rank {D.rank()} holds (tensors, entries) "
                               f"{mine.tolist()}, rank 0 "
                               f"{layout.tolist()}: the ranks were not set "
                               f"up alike")
        D.broadcast_(state)
        self.generator.set_state(gen)

    def _stage_footprint(self, res) -> int:
        """Raster footprint from the marching-cubes voxel: a triangle never
        exceeds one voxel, so its projected bbox is bounded by
        2 voxel * focal / nearest depth (the dataset's camera; JAX
        trainer.py:1177-1186), clipped to the mesh kernel's 32 px cells.
        The body's depth is the camera's T plus the nearest frame's trans:
        JAX's scenes keep it in T, the port's in trans (dataset.py), and
        both give the same footprint.  The port bins a wider face into
        every cell it covers, so this only picks the cell size
        (``mesh_cell_size``)."""
        spacing, _ = grid_world_coords(tuple(res[-1]), self.b_min,
                                       self.b_max)
        cp = self.dataset.camera_params
        depth = (float(cp["world2cam_coord_trans"][2])
                 + float(self.dataset.trans[:, 2].min()))
        z_min = max(depth - float(self.b_max[2]), 0.3)
        vox = float(spacing.max())
        return int(np.clip(np.ceil(
            2.0 * vox * float(cp["focal_length"][0]) / z_min) + 2, 6, 32))

    # -- stages -------------------------------------------------------------
    def set_stage(self, name: str):
        conf = self.conf
        tr = conf.get_config(f"train.{name}.point_render")
        wc = conf.get_config(f"loss_{name}")
        lw = LossWeights(
            color_weight=wc.get_float("color_weight"),
            normal_weight=wc.get_float("normal_weight"),
            weighted_normal=wc.get_bool("weighted_normal"),
            grad_weight=wc.get_float("grad_weight"),
            offset_weight=wc.get_float("offset_weight"),
            def_regu_weight=wc.get_float("def_regu.weight"),
            def_regu_c=wc.get_float("def_regu.c"),
            dct_weight=wc.get_float("dct_weight"),
            pc_weight=wc.get_float("pc_weight.weight"),
            laplacian_weight=wc.get_float("pc_weight.laplacian_weight"),
            edge_weight=wc.get_float("pc_weight.edge_weight"),
            norm_weight=wc.get_float("pc_weight.norm_weight"),
            def_consistent_weight=wc.get_float(
                "pc_weight.def_consistent.weight"),
            def_consistent_c=wc.get_float("pc_weight.def_consistent.c"),
            sample_pix_num=(wc.get_int("sample_pix_num")
                            if "sample_pix_num" in wc else 0))
        occ = conf.get_config("train.opt_camera")
        res = tuple(tuple(r) for r in self.resolutions[name])
        self.stage_cfg = StageStatic(
            name=name, N=tr.get_int("batch_size"),
            H=self.dataset.H, W=self.dataset.W,
            sample_pix=conf.get_int("train.sample_pix_num"),
            radius=tr.get_float("radius"),
            remesh_intersect=tr.get_int("remesh_intersect"),
            resolutions=res, weights=lw, window=self.window,
            opt_pose=conf.get_bool("train.opt_pose"),
            opt_trans=conf.get_bool("train.opt_trans"),
            opt_cam_focal=occ.get_bool("focal_length"),
            opt_cam_principal=occ.get_bool("princeple_points"),
            opt_cam_quat=occ.get_bool("quat"),
            opt_cam_T=occ.get_bool("T"),
            has_normals=self.dataset.has_normals,
            raster_footprint=self._stage_footprint(res))
        self._step_fn = None
        # the new stage remeshes at its first step, at its own resolutions
        self.forward_time = 0

    def override_stage(self, **kw):
        """Replace static stage fields (tests shrink sample counts)."""
        self.stage_cfg = dataclasses.replace(self.stage_cfg, **kw)
        self._step_fn = None

    def _get_step_fn(self):
        if self._step_fn is None:
            self._step_fn = make_train_step(
                self.nets, self.skinner, self.stage_cfg, self.dctnull,
                self.ang_thresh, self.optimizer)
        return self._step_fn

    # -- debug artifacts (reference save_debug, model/network.py:374-447) ----
    @torch.no_grad()
    def save_debug(self, debug_root: str, fids, batch):
        """Dump the template and, per frame of fids, its deformed and
        translator-only meshes (tmp.ply, def_i.ply, def1_i.ply), the splat
        mask (m{i}.png, the splat forward kernel on the card), the GT mask
        when batch is given (gm{i}.png), and a Phong render and a face-normal
        image of the rasterized deformed mesh (rgb{i}.png, n{i}.png; the
        mesh kernel).  Seen through the dataset's camera, as in JAX."""
        import cv2
        from ..render.shading import phong_shade
        os.makedirs(debug_root, exist_ok=True)
        tmp, cfg = self.tmp, self.stage_cfg
        faces = tmp.faces.long()
        write_mesh = meshops.write_mesh
        write_mesh(osp.join(debug_root, "tmp.ply"), tmp.verts, faces)
        fids_t = torch.as_tensor(np.asarray(fids), device=self.device)
        N, nv = len(fids_t), tmp.verts.shape[0]
        binds = torch.arange(N, device=self.device).repeat_interleave(nv)
        dv, off = deformer_apply(
            self.nets.translator, self.skinner, tmp.verts.repeat(N, 1), binds,
            self.bank["dcond"][fids_t], self.bank["poses"][fids_t],
            self.bank["trans"][fids_t], 1.0)
        dv, off = dv.reshape(N, nv, 3), off.reshape(N, nv, 3)
        cp = self.dataset.camera_params
        cam = make_camera(cp["focal_length"], cp["princeple_points"],
                          cp["cam2world_coord_quat"],
                          cp["world2cam_coord_trans"], self.dataset.H,
                          self.dataset.W, device=self.device)
        valid = torch.ones(nv, dtype=torch.bool, device=self.device)

        def png(name, img):
            cv2.imwrite(osp.join(debug_root, name),
                        (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())

        for i in range(N):
            write_mesh(osp.join(debug_root, f"def_{i}.ply"), dv[i], faces)
            write_mesh(osp.join(debug_root, f"def1_{i}.ply"),
                       tmp.verts + off[i], faces)
            png(f"m{i}.png", splat_mask(cam, dv[i], valid, cfg.radius))
            if batch is not None:
                cv2.imwrite(osp.join(debug_root, f"gm{i}.png"),
                            (np.asarray(batch["mask"][i]) * 255).astype(
                                np.uint8))
            frags = rasterize_mesh(cam, dv[i], faces, cfg.raster_footprint)
            rgb, hit = phong_shade(cam, dv[i], faces, frags, cam_pos(cam))
            fn = meshops.face_normals(dv[i], faces)
            nimg = torch.where(hit[..., None],
                               fn[frags.pix_to_face.clamp_min(0).long()] * 0.5
                               + 0.5, torch.ones_like(rgb))
            png(f"rgb{i}.png", rgb)
            png(f"n{i}.png", nimg)

    # -- one optimization step ---------------------------------------------
    def step_batch(self, fids, batch: dict):
        """The step's frame arguments: (gtCs, gtMs, gtNs, fids, windows) on
        the device, from frames fids and their uint8 batch."""
        windows, _ = self.dataset.window_indices(fids, self.stage_cfg.window)
        gtCs, gtMs, gtNs = image_batch(batch, self.device)
        if gtNs is None:
            gtNs = torch.zeros_like(gtCs)
        return (gtCs, gtMs, gtNs, to_device(np.asarray(fids), self.device),
                to_device(windows, self.device))

    def train_step(self, fids, batch: dict, lr: float) -> Dict[str, float]:
        with trace.span("train_step"):
            cfg = self.stage_cfg
            if self.forward_time % cfg.remesh_intersect == 0:
                self.remesh(1.0)
            step = self._get_step_fn()
            t0 = time.perf_counter()
            ratios = (1.0, self.opt_times / 2500.0 + 0.5, 1.0)
            with trace.span("step.feed"):
                draws = draw_step_noise(cfg, self.tmp.verts.shape[0],
                                        self.generator, self.device)
                frames = self.step_batch(fids, batch)
            self.tmp, info = step(self.bank, self.tmp, *frames, ratios, lr,
                                  draws)
            self.timings["steps"].append(time.perf_counter() - t0)
            self.remesh_time = (np.floor(self.remesh_time)
                                + (self.forward_time % cfg.remesh_intersect)
                                / cfg.remesh_intersect)
            self.forward_time += 1
            self.opt_times += 1
            info["remesh"] = self.remesh_time
            self.history.append(info)
            return info


# ---------------------------------------------------------------------------
# Synthetic end-to-end (tests, timing tools, throughput)
# ---------------------------------------------------------------------------

_DEFAULT_TEST_RES = [(9, 9, 9), (17, 17, 17), (33, 33, 33)]
_BENCH_RES = [(17, 17, 17), (33, 33, 33), (65, 65, 65)]
CONFIGS = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(
    __file__)))), "configs")


def build_synthetic_trainer(tmp_root: str, n_frames: int = 8, H: int = 96,
                            W: int = 96, resolutions=None,
                            smpl_verts: int = 400,
                            conf_name: str = "config.conf", device="cuda"):
    """A full trainer on the disk-silhouette scene (``make_synthetic_scene``,
    written into <tmp_root>/scene unless it is there) and the toy body, with
    the SDF at its geometric init (no IGR): JAX's build_synthetic_trainer.
    Returns (trainer, dataset)."""
    from ..config import parse_file
    from ..data.dataset import SceneDataset, make_synthetic_scene
    from ..models.smpl import toy_smpl_model

    scene = osp.join(tmp_root, "scene")
    if not osp.isdir(osp.join(scene, "imgs")):
        os.makedirs(scene, exist_ok=True)
        make_synthetic_scene(scene, n_frames=n_frames, H=H, W=W)
    ds = SceneDataset(scene, conds_lens={"deformer": 128, "renderer": 256})
    conf = parse_file(osp.join(CONFIGS, conf_name))
    res = resolutions or {s: _DEFAULT_TEST_RES
                          for s in ("coarse", "medium", "fine")}
    tr = Trainer(ds, toy_smpl_model(n_verts=smpl_verts), conf, res,
                 skinner_res=(17, 29, 9), device=device)
    return tr, ds


def _bench_trainer(sample_rays: int, H: int, W: int, root, resolutions,
                   device):
    """The fine-stage trainer of the throughput runs, remeshed, with
    sample_rays rays a step."""
    import tempfile
    root = root or osp.join(tempfile.gettempdir(), f"srtpu_bench_{H}")
    os.makedirs(root, exist_ok=True)
    res = resolutions or _BENCH_RES
    tr, ds = build_synthetic_trainer(
        root, n_frames=32, H=H, W=W,
        resolutions={s: res for s in ("coarse", "medium", "fine")},
        device=device)
    tr.set_stage("fine")
    if tr.rays_per_step() != sample_rays:
        tr.override_stage(weights=dataclasses.replace(
            tr.stage_cfg.weights,
            sample_pix_num=sample_rays // tr.stage_cfg.N))
    tr.remesh(1.0)
    return tr, ds


BENCH_RATIOS = (1.0, 0.5, 1.0)
BENCH_LR = 1e-4


def build_synthetic_bench_step(sample_rays: int = 6144, H: int = 512,
                               W: int = 512, root: Optional[str] = None,
                               resolutions=None, device="cuda"):
    """The real training step at a production-like scale: returns
    (run, args), run(*args) taking one step on frames 0..N-1 and returning
    its loss; run.step is the step, run.trainer its trainer."""
    tr, ds = _bench_trainer(sample_rays, H, W, root, resolutions, device)
    step = tr._get_step_fn()
    cfg = tr.stage_cfg
    fids = np.arange(cfg.N)
    draws = draw_step_noise(cfg, tr.tmp.verts.shape[0], tr.generator,
                            tr.device)
    args = (tr.bank, tr.tmp, *tr.step_batch(fids, ds.batch_raw(fids)),
            BENCH_RATIOS, BENCH_LR, draws)

    def run(*a):
        return step(*a)[1]["loss"]

    run.step = step
    run.trainer = tr
    return run, args


def bench_throughput(sample_rays: int = 6144, H: int = 512, W: int = 512,
                     iters: int = 30, n_batches: int = 8,
                     root: Optional[str] = None, resolutions=None,
                     device="cuda"):
    """Steady-state training throughput on a real optimization trajectory:
    the template and the optimizer state thread through, every iteration
    feeds another frame batch (rotating over n_batches of the 32-frame
    scene) and its own draws from the trainer's generator, and the warm
    remesh at the trained state is amortized at the stage's
    remesh_intersect.  Returns (steps/s, {step_s, remesh_s,
    remesh_intersect})."""
    tr, ds = _bench_trainer(sample_rays, H, W, root, resolutions, device)
    step = tr._get_step_fn()
    cfg = tr.stage_cfg
    nv = tr.tmp.verts.shape[0]
    fid_groups = [(np.arange(cfg.N) + i * cfg.N) % ds.frame_num
                  for i in range(n_batches)]
    batches = [tr.step_batch(f, ds.batch_raw(f)) for f in fid_groups]

    def one(tmp, i):
        draws = draw_step_noise(cfg, nv, tr.generator, tr.device)
        return step(tr.bank, tmp, *batches[i % n_batches], BENCH_RATIOS,
                    BENCH_LR, draws)[0]

    tmp = one(tr.tmp, 0)            # the first step, out of the timing
    tr._sync()
    t0 = time.perf_counter()
    for i in range(iters):
        tmp = one(tmp, i)
    tr._sync()
    step_s = (time.perf_counter() - t0) / iters

    tr.tmp = tmp
    tr.remesh(1.0)                  # synchronized; its seconds in timings
    remesh_s = tr.timings["remesh"]
    eff_s = step_s + remesh_s / max(cfg.remesh_intersect, 1)
    return 1.0 / eff_s, {"step_s": step_s, "remesh_s": remesh_s,
                         "remesh_intersect": cfg.remesh_intersect}
