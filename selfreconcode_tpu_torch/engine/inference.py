"""Inference: per-frame mesh renders, offset-only renders and IDR colours
(torch port of ``selfreconcode_tpu/engine/inference.py``).

Per frame, a geometry pass deforms the template into the frame,
rasterizes it (the mesh kernel of ``ops/mesh_kernels.py``), Phong-shades
it, scores the hit mask against the GT mask (maskE = 1 - IoU), renders the
translator-only deformation from a fixed frontal camera (def1), and seeds
one canonical point per hit pixel from the fragments.  A colour pass then
solves only the hit pixels, in chunks: 30 Newton iterations with early
exit, SDF normals, Jacobian-inverse view directions and the colour net,
composited over white.  Everything runs without a graph, apart from the
local autograd passes for normals and Jacobians.
"""
from __future__ import annotations

import time

import torch

from ..models.deformer import deformer_apply, deformer_jacobian
from ..models.sdf import sdf_value_and_grad
from ..models.skinner import fk_transforms
from ..ops.rasterize import rasterize_mesh
from ..render.camera import Camera, cam_pos, make_camera, view_rays
from ..render.shading import phong_shade
from ..utils.math import inv3x3, normalize
from .surface import (SurfaceConfig, optimize_surface_points,
                      surface_inits_from_fragments)


def make_infer_fn(trainer, footprint: int = 8, notcolor: bool = False,
                  chunk: int = 65536, early_exit: bool = True):
    """Returns infer_frame(bank, tmp, fid, gt_mask) -> dict of per-frame
    outputs, and infer_frame.batched(bank, tmp, fids, gt_masks) -> list.

    The nets and the skinner come from the trainer; `footprint` picks the
    raster cell size (``rasterize_mesh``); `chunk` is the colour solve's
    batch of hit pixels (clamped to H*W); `early_exit` ends a chunk's
    solve once every point converged (``tools/bench_infer.py
    --no-early-exit`` runs all 30 iterations).  Each output dict holds
    mesh_img, def1_img, color_img (H, W, 3), hit (H, W), mask_err,
    def_verts (nv, 3), and stats: geom_s, color_s (seconds, synchronized),
    hit_pixels, converged_pixels."""
    nets = trainer.nets
    sdf_net, translator, render_net = nets.sdf, nets.translator, nets.netRender
    skinner = trainer.skinner
    surf_nets = (sdf_net, translator, skinner)
    H, W = trainer.dataset.H, trainer.dataset.W
    chunk = int(min(chunk, H * W))
    # the reference loosens the distance threshold to 1e-4 and runs 30
    # iterations at inference (model/network.py:342-363)
    cfg = SurfaceConfig(n_iters=30, dthreshold=1e-4,
                        athreshold_deg=trainer.ang_thresh,
                        early_exit=early_exit)

    def clock(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def frame(bank, fid):
        sl = slice(int(fid), int(fid) + 1)
        return bank["poses"][sl], bank["trans"][sl], bank["dcond"][sl]

    def geom(bank, tmp, fid, gt_mask):
        dev = tmp.verts.device
        cam = make_camera(bank["focal_length"], bank["princeple_points"],
                          bank["cam2world_coord_quat"],
                          bank["world2cam_coord_trans"], H, W, device=dev)
        poses, trans, dcond = frame(bank, fid)
        nv = tmp.verts.shape[0]
        binds = torch.zeros(nv, dtype=torch.long, device=dev)
        def_verts, _ = deformer_apply(translator, skinner, tmp.verts, binds,
                                      dcond, poses, trans, 1.0)
        frags = rasterize_mesh(cam, def_verts, tmp.faces, footprint)
        mesh_img, hit = phong_shade(cam, def_verts, tmp.faces, frags,
                                    cam_pos(cam))
        m = hit.float()
        inter = (m * gt_mask).sum()
        union = (m + gt_mask - m * gt_mask).abs().sum()
        mask_err = 1.0 - inter / union.clamp_min(1e-8)

        # def1: the translator-only deformation from a fixed frontal camera
        # (network.py:332-339): R = diag(-1, 1, -1), T = mean trans
        tverts, _ = translator(tmp.verts, dcond[0], 1.0)
        cam1 = Camera(focal=cam.focal, principal=cam.principal,
                      R=torch.diag(torch.tensor([-1.0, 1.0, -1.0],
                                                device=dev)),
                      T=bank["trans"].mean(0), H=H, W=W)
        frags1 = rasterize_mesh(cam1, tverts, tmp.faces, footprint)
        light1 = cam_pos(cam1) + torch.tensor([0.0, 1.0, 0.0], device=dev)
        def1_img, _ = phong_shade(cam1, tverts, tmp.faces, frags1, light1)
        out = {"mesh_img": mesh_img, "hit": hit, "mask_err": mask_err,
               "def1_img": def1_img, "def_verts": def_verts}
        init_pts, valid = surface_inits_from_fragments(
            tmp.verts, tmp.faces, frags.pix_to_face, frags.bary)
        return out, cam, init_pts.reshape(-1, 3), valid.reshape(-1)

    def color(bank, fid, cam, init_pts, valid):
        dev = init_pts.device
        poses, trans, dcond = frame(bank, fid)
        A = fk_transforms(skinner, poses)[0]
        c = cam_pos(cam)
        pix = torch.arange(H * W, device=dev)
        rays = view_rays(cam, torch.stack([(pix % W).float(),
                                           (pix // W).float(),
                                           torch.ones(H * W, device=dev)],
                                          dim=-1))
        img = torch.ones((H * W, 3), device=dev)
        hit_idx = torch.nonzero(valid).squeeze(1)
        n_conv = torch.zeros((), dtype=torch.long, device=dev)
        for lo in range(0, hit_idx.numel(), chunk):
            idx = hit_idx[lo:lo + chunk]
            v = rays[idx]
            bflat = torch.zeros(idx.numel(), dtype=torch.long, device=dev)
            pts, done = optimize_surface_points(
                surf_nets, cfg, 1.0, 1.0, dcond, poses, trans, v, c,
                init_pts[idx], bflat)
            _, g, feat = sdf_value_and_grad(sdf_net, pts, 1.0,
                                            create_graph=False)
            jac, _ = deformer_jacobian(translator, skinner, pts, bflat, dcond,
                                       A, trans, 1.0, create_graph=False)
            jinv, ok = inv3x3(jac)
            crays = torch.where(ok[:, None],
                                torch.einsum("nij,nj->ni", jinv, v), v)
            colors = render_net(pts, normalize(g), normalize(crays),
                                feat.detach(), 1.0)
            colors = (colors / 2.0 + 0.5).clamp(0.0, 1.0)
            img[idx[done]] = colors[done]
            n_conv += done.sum()
        return img.reshape(H, W, 3), int(hit_idx.numel()), int(n_conv)

    def infer_frame(bank, tmp, fid, gt_mask):
        with torch.no_grad():
            dev = tmp.verts.device
            t0 = clock(dev)
            out, cam, init_pts, valid = geom(bank, tmp, fid, gt_mask)
            t1 = clock(dev)
            stats = {"geom_s": t1 - t0}
            if not notcolor:
                out["color_img"], n_hit, n_conv = color(bank, fid, cam,
                                                        init_pts, valid)
                stats.update(color_s=clock(dev) - t1, hit_pixels=n_hit,
                             converged_pixels=n_conv)
            out["stats"] = stats
            return out

    def infer_batch(bank, tmp, fids, gt_masks):
        return [infer_frame(bank, tmp, f, m) for f, m in zip(fids, gt_masks)]

    infer_frame.batched = infer_batch
    return infer_frame
