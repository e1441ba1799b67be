"""One training step of SelfRecon in plain PyTorch: the geom pass (ray
seeds), the inner pass (the splat silhouette's IoU and the
deformation-consistency term, SGD with momentum on the template) and the
outer pass (the surface points with their implicit-function-theorem
gradient, the eikonal, deformation, DCT, colour, normal and SDF-anchor
terms, then Adam), for one process and one device.  The same equations as
the port's ``engine/trainer.py::make_train_step``; the splat is
``reference/splat.py``'s dense form, not the port's kernels.

Three keys of the configuration's ``train`` block choose the step's
algorithm (``stage_from_conf``); by default the port's departures from the
published step, which every cell runs:

  point_inits  seeds from the nearest projected template vertex (true) or,
               as published, from the nearest rasterized face at its
               barycentrics (false; ``reference/raster.py``)
  surf_newton  the surface solve by Gauss-Newton (true) or, as published,
               by Cauchy steps (false; ``reference/surface.py``)
  anchor_sub   the SDF anchor over that many template vertices drawn at
               random (16384), or over every vertex (0, as published)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import losses as L
from .camera import Camera, cam_pos, transform_points_screen, view_rays
from .deformer import deformer_apply, deformer_jacobian, point_jacobian
from .mathops import (gm_robust, inv3x3, log_singular_values_sq_sum,
                      normalize, quat2mat)
from .raster import fragment_seeds
from .render import RenderNet
from .sampling import sample_points, subsample_mask_topk
from .sdf import SDFNet, sdf_grad, sdf_value_and_grad
from .skinner import frame_rows, posed_skeleton, skinner_apply_shared
from .splat import splat_mask
from .surface import SurfaceConfig, surface_points
from .translator import TranslatorNet

EIK_TMP = 4096        # template vertices in the eikonal and deformation terms
ANCHOR_SUB = 16384    # template vertices in the SDF anchor (anchor_sub's
                      # default)
SURF_ITERS = 10       # iterations of the surface solve in training


@dataclass(frozen=True)
class Stage:
    """One stage of a configuration, as the step reads it."""
    name: str
    N: int
    H: int
    W: int
    rays_per_frame: int
    radius: float
    remesh_intersect: int
    resolutions: Tuple[Tuple[int, int, int], ...]
    weights: Dict[str, float]
    window: int
    trainable: Dict[str, bool]      # the bank leaves' flags
    has_normals: bool
    point_inits: bool = True        # False: seeds from rasterized faces
    surf_newton: bool = True        # False: the Cauchy surface solve
    anchor_sub: int = ANCHOR_SUB    # 0: the anchor over every vertex

    def rays(self) -> int:
        return self.rays_per_frame * self.N


def _f(x) -> float:
    return float(x)


def step_algorithm(conf: dict) -> Dict[str, object]:
    """The step's algorithm, from three optional keys of a configuration
    tree's ``train`` block, named as the port's ``StageStatic`` fields, each
    defaulting to the port's departure from the published step:
    ``point_inits`` (bool, default true; false seeds the rays from the
    rasterized template), ``surf_newton`` (bool, default true; false solves
    by Cauchy steps) and ``anchor_sub`` (int, default 16384; 0 anchors
    every vertex)."""
    tr = conf["train"]
    return {"point_inits": bool(tr.get("point_inits", True)),
            "surf_newton": bool(tr.get("surf_newton", True)),
            "anchor_sub": int(tr.get("anchor_sub", ANCHOR_SUB))}


def stage_from_conf(conf: dict, name: str, H: int, W: int, resolutions,
                    window: int, has_normals: bool) -> Stage:
    """The stage `name` of a configuration tree (config.conf as a dict),
    with the step's algorithm of ``step_algorithm``."""
    tr = conf["train"]
    pr = tr[name]["point_render"]
    lw = conf[f"loss_{name}"]
    pc = lw["pc_weight"]
    weights = {
        "color": _f(lw["color_weight"]), "normal": _f(lw["normal_weight"]),
        "weighted_normal": bool(lw["weighted_normal"]),
        "grad": _f(lw["grad_weight"]), "offset": _f(lw["offset_weight"]),
        "def_regu": _f(lw["def_regu"]["weight"]),
        "def_regu_c": _f(lw["def_regu"]["c"]), "dct": _f(lw["dct_weight"]),
        "pc": _f(pc["weight"]), "pc_mask": 1.0,
        "laplacian": _f(pc["laplacian_weight"]), "edge": _f(pc["edge_weight"]),
        "norm": _f(pc["norm_weight"]),
        "def_consistent": _f(pc["def_consistent"]["weight"]),
        "def_consistent_c": _f(pc["def_consistent"]["c"])}
    for k in ("laplacian", "edge", "norm", "offset"):
        if weights[k] > 0.0:
            raise ValueError(f"loss_{name}: the reference step has no "
                             f"{k} term (its weight is {weights[k]})")
    cam = tr["opt_camera"]
    trainable = {"poses": bool(tr["opt_pose"]), "trans": bool(tr["opt_trans"]),
                 "dcond": True, "rcond": True,
                 "focal_length": bool(cam["focal_length"]),
                 "princeple_points": bool(cam["princeple_points"]),
                 "cam2world_coord_quat": bool(cam["quat"]),
                 "world2cam_coord_trans": bool(cam["T"])}
    return Stage(name=name, N=int(pr["batch_size"]), H=H, W=W,
                 rays_per_frame=int(lw.get("sample_pix_num",
                                           tr["sample_pix_num"])),
                 radius=_f(pr["radius"]),
                 remesh_intersect=int(pr["remesh_intersect"]),
                 resolutions=tuple(tuple(int(v) for v in r)
                                   for r in resolutions),
                 weights=weights, window=window, trainable=trainable,
                 has_normals=has_normals, **step_algorithm(conf))


class Nets(nn.Module):
    """The three MLPs under the port's module names (sdf.lin{l}.*,
    deformer.defs.0.lin{l}.*, netRender.lin{l}.*)."""

    def __init__(self, conf: dict):
        super().__init__()
        self.sdf = SDFNet(multires=int(conf["sdf_net"]["multires"]))
        self.deformer = nn.Module()
        self.deformer.defs = nn.ModuleList([TranslatorNet(
            cond_size=int(conf["mlp_deformer"]["condlen"]),
            multires=int(conf["mlp_deformer"]["multires"]))])
        self.netRender = RenderNet(
            feature_size=int(conf["render_net"]["condlen"]),
            multires_v=int(conf["render_net"]["multires_v"]))

    @property
    def translator(self) -> TranslatorNet:
        return self.deformer.defs[0]


class Draws(NamedTuple):
    sel_scores: torch.Tensor
    eik_scores: torch.Tensor
    eik_normal: torch.Tensor
    eik_uniform: torch.Tensor
    def_normal: torch.Tensor
    anchor_scores: Optional[torch.Tensor]


def draw_noise(stage: Stage, nv: int, generator, device) -> Draws:
    """Every random number of one step, in the order the port draws them."""
    S = stage.rays() + min(EIK_TMP, nv)
    kw = dict(generator=generator, device=device)
    return Draws(
        sel_scores=torch.rand(stage.N * stage.H * stage.W, **kw),
        eik_scores=torch.rand(nv, **kw),
        eik_normal=torch.randn(S, 3, **kw),
        eik_uniform=torch.rand(S // 6, 3, **kw),
        def_normal=torch.randn(S, 3, **kw),
        anchor_scores=(torch.rand(nv, **kw) if 0 < stage.anchor_sub < nv
                       else None))


def camera(bank, stage: Stage) -> Camera:
    """The shared camera; frozen leaves enter detached."""
    def leaf(k):
        return bank[k] if stage.trainable[k] else bank[k].detach()
    R = quat2mat(leaf("cam2world_coord_quat").reshape(1, 4))[0]
    return Camera(focal=leaf("focal_length").reshape(2),
                  principal=leaf("princeple_points").reshape(2), R=R,
                  T=leaf("world2cam_coord_trans").reshape(3), H=stage.H,
                  W=stage.W)


def point_seeds(cam: Camera, verts, def_verts):
    """Per frame, the template vertex whose projection is the nearest at
    each pixel: (seeds (N, H, W, 3), covered (N, H, W))."""
    H, W = cam.H, cam.W
    nv = verts.shape[0]
    big = 3e38
    seed = torch.cat([verts, verts.new_zeros(1, 3)])
    inits, covers = [], []
    for dv in def_verts:
        s = transform_points_screen(cam, dv)
        col = torch.round(s[:, 0]).long()
        row = torch.round(s[:, 1]).long()
        z = s[:, 2]
        ok = (z > 0.0) & (col >= 0) & (col < W) & (row >= 0) & (row < H)
        pix = row.clamp(0, H - 1) * W + col.clamp(0, W - 1)
        zimg = torch.full((H * W,), big, device=verts.device)
        zimg.scatter_reduce_(0, pix[ok], z[ok], "amin")
        win = ok & (z <= zimg[pix])
        vid = torch.full((H * W,), nv, dtype=torch.long, device=verts.device)
        vid.scatter_reduce_(0, pix[win],
                            torch.arange(nv, device=verts.device)[win],
                            "amin")
        covers.append((zimg < big).reshape(H, W))
        inits.append(seed[vid].reshape(H, W, 3))
    return torch.stack(inits), torch.stack(covers)


def step(nets: Nets, skinner, stage: Stage, dctnull: np.ndarray,
         ang_thresh_deg: float, optimizer, bank, verts, momentum, gtCs, gtMs,
         gtNs, fids, windows, ratios, lr: float, draws: Draws, faces=None):
    """One step: updates the nets and the bank in place (Adam) and returns
    (new template verts, new momentum, info, the template's gradient).
    Afterwards each leaf's .grad holds the masked gradient Adam took.
    faces, the template's, are read when the stage seeds from fragments;
    info's ``raster_ties`` then counts the tied pixels of its frames."""
    w = stage.weights
    N, H, W = stage.N, stage.H, stage.W
    P = stage.rays()
    radius_px = int(np.round(stage.radius / 2.0 * float(min(H, W)) / 1.2))
    sdf_net, translator, render_net = nets.sdf, nets.translator, nets.netRender
    r_sdf, r_def, r_ren = ratios
    dev = verts.device
    optimizer.zero_grad(set_to_none=False)

    def frame_params():
        poses, trans = bank["poses"][fids], bank["trans"][fids]
        if not stage.trainable["poses"]:
            poses = poses.detach()
        if not stage.trainable["trans"]:
            trans = trans.detach()
        return poses, trans, bank["dcond"][fids]

    nv = verts.shape[0]
    binds_v = torch.arange(N, device=dev).repeat_interleave(nv)
    # geom pass
    with torch.no_grad():
        cam = camera(bank, stage)
        poses, trans, dcond = frame_params()
        dv = deformer_apply(translator, skinner, verts.repeat(N, 1), binds_v,
                            dcond, poses, trans, r_def)[0].reshape(N, nv, 3)
        if stage.point_inits:
            inits, covers = point_seeds(cam, verts, dv)
        else:
            inits, covers, ties = fragment_seeds(cam, verts, faces, dv)
        mgtMs = L.max_pool_mask(gtMs, radius_px)
        sel = covers & (gtMs > 0.0)
        idx, sel_ok = subsample_mask_topk(sel.reshape(-1), P,
                                          scores=draws.sel_scores)
        init_pts = inits.reshape(-1, 3)[idx]

    # inner pass
    tv = verts.detach().requires_grad_(True)
    cam = camera(bank, stage)
    poses, trans, dcond = frame_params()
    def_verts = deformer_apply(translator, skinner, tv.repeat(N, 1), binds_v,
                               dcond, poses, trans, r_def)[0].reshape(N, nv, 3)
    masks = torch.stack([splat_mask(cam, def_verts[i], stage.radius)
                         for i in range(N)])
    mask_loss = L.iou_mask_loss(masks, mgtMs)
    pc_loss = mask_loss * w["pc_mask"]
    info = {"pc_mask_loss": mask_loss.detach()}
    if not stage.point_inits:
        info["raster_ties"] = torch.tensor(ties)
    valid_v = torch.ones(nv, dtype=torch.bool, device=dev)
    if w["def_consistent"] > 0.0:
        lbs_b = skinner_apply_shared(skinner, tv, poses, trans)
        dc = L.def_consistency_loss(def_verts, lbs_b, valid_v,
                                    w["def_consistent_c"])
        pc_loss = pc_loss + w["def_consistent"] * dc
        info["pc_defconst_loss"] = dc.detach()
    pc_loss.backward()
    with torch.no_grad():
        g_tmp = tv.grad.clone()
        new_mom = 0.9 * momentum + tv.grad
        new_verts = verts - 0.05 * new_mom

    # outer pass
    rem = idx % (H * W)
    ray_binds, ray_rows, ray_cols = idx // (H * W), rem // W, rem % W
    cam = camera(bank, stage)
    poses, trans, dcond = frame_params()
    n_rays = ray_rows.shape[0]
    pix = torch.stack([ray_cols.float(), ray_rows.float(),
                       torch.ones(n_rays, device=dev)], dim=-1)
    rays_w = view_rays(cam, pix)
    surf_cfg = SurfaceConfig(n_iters=SURF_ITERS, athreshold_deg=ang_thresh_deg,
                             newton=stage.surf_newton)
    pts, done = surface_points((sdf_net, translator, skinner), surf_cfg, r_sdf,
                               r_def, dcond, poses, trans, rays_w,
                               cam_pos(cam), init_pts, ray_binds)
    done = done & sel_ok
    info["ray_converged"] = done.sum()
    use_normals = stage.has_normals and w["normal"] > 0.0
    if use_normals:
        flip = torch.tensor([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]],
                            device=dev)
        gtn = gtNs[ray_binds, ray_rows, ray_cols]
        gtn_w = torch.einsum("ij,nj->ni", cam.R @ flip, gtn)
        norms = torch.linalg.norm(gtn_w, dim=-1, keepdim=True)
        gtn_w, nok = gtn_w / norms.clamp_min(1e-4), norms[..., 0] > 1e-4
    else:
        nok = torch.zeros_like(done)
    with torch.no_grad():
        cnt_c = L.frame_counts(ray_binds, done, N)
        cnt_n = L.frame_counts(ray_binds, nok & done, N)

    nvn = new_verts.detach()
    tidx, _ = subsample_mask_topk(valid_v, min(EIK_TMP, nv),
                                  scores=draws.eik_scores)
    base = torch.cat([pts.detach(), nvn[tidx]], dim=0)
    nonmnfld = sample_points(base, 1.8, 0.01,
                             noise=(draws.eik_normal, draws.eik_uniform))
    g_eik = sdf_grad(sdf_net, nonmnfld, r_sdf)
    grad_loss = ((torch.linalg.norm(g_eik, dim=-1) - 1.0) ** 2).mean()
    info["grad_loss"] = grad_loss
    total = grad_loss * w["grad"]

    if w["def_regu"] > 0.0:
        jit = sample_points(base, 1.8, 0.01, ratio=0, noise=(draws.def_normal,))
        dr_pts = torch.cat([base, jit], dim=0)
        M = dr_pts.shape[0]
        bd = torch.arange(N, device=dev).repeat_interleave(M)
        conds = frame_rows(dcond, bd)
        jac, _ = point_jacobian(lambda q: translator(q, conds, r_def)[0],
                                dr_pts.repeat(N, 1))
        s2 = log_singular_values_sq_sum(jac)
        def_loss = gm_robust(s2, w["def_regu_c"], square=True).mean()
        info["def_loss"] = def_loss
        total = total + def_loss * w["def_regu"]

    if (stage.trainable["poses"] or stage.trainable["trans"]) \
            and w["dct"] > 0.0:
        wposes = bank["poses"][windows]
        if not stage.trainable["poses"]:
            wposes = wposes.detach()
        Nw = windows.shape[1]
        pj = posed_skeleton(skinner, wposes.reshape(N * Nw, 24, 3))
        dct_loss = L.dct_prior_loss(torch.as_tensor(dctnull, device=dev),
                                    pj.reshape(N, Nw, 24, 3))
        info["dct_loss"] = dct_loss
        total = total + dct_loss * w["dct"]

    _, g_pts, feat = sdf_value_and_grad(sdf_net, pts, r_sdf)
    nx = normalize(g_pts)
    jac_d, _ = deformer_jacobian(translator, skinner, pts, ray_binds, dcond,
                                 poses, trans, r_def)
    jinv, inv_ok = inv3x3(jac_d)
    info["inv_ok"] = inv_ok.sum()
    crays = torch.einsum("nij,nj->ni", jinv, rays_w)
    crays = normalize(torch.where(inv_ok[:, None], crays, rays_w))
    if w["color"] > 0.0:
        colors = render_net(pts, nx, crays, feat, r_ren)
        gt = gtCs[ray_binds, ray_rows, ray_cols]
        color_loss = L.color_l1_loss(colors, gt, ray_binds, done, cnt_c)
        info["color_loss"] = color_loss
        total = total + w["color"] * color_loss
    if use_normals:
        with torch.no_grad():
            ndef = torch.einsum("nji,nj->ni", jinv, nx)
            ndef = torch.where(inv_ok[:, None], ndef,
                               torch.einsum("nij,nj->ni", jac_d, nx))
            ndef = normalize(ndef)
            if w["weighted_normal"]:
                wgt = ((-rays_w * ndef).sum(-1)).clamp(0.0, 1.0) ** 2
            else:
                wgt = torch.ones(n_rays, device=dev)
        gtn_c = torch.einsum("nji,nj->ni", jac_d, gtn_w)
        normal_loss = L.normal_loss(gtn_c, nx, wgt, ray_binds, nok & done,
                                    cnt_n)
        info["normal_loss"] = normal_loss
        total = total + w["normal"] * normal_loss
    if draws.anchor_scores is not None:
        aidx, avalid = subsample_mask_topk(valid_v, stage.anchor_sub,
                                           scores=draws.anchor_scores)
        averts = nvn[aidx]
    else:
        averts, avalid = nvn, valid_v
    anchor = L.sdf_anchor_loss(sdf_net(averts, r_sdf)[0], avalid, 0.0)
    info["pc_loss_sdf"] = anchor
    total = total + anchor * w["pc"]
    total.backward()
    info["loss"] = total.detach() + pc_loss.detach()

    with torch.no_grad():
        for k, trainable in stage.trainable.items():
            if not trainable and bank[k].grad is not None:
                bank[k].grad.zero_()
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    optimizer.step()
    return (new_verts, new_mom, {k: float(v.detach()) for k, v in info.items()},
            g_tmp)
