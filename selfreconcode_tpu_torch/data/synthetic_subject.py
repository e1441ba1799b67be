"""Realistic-fidelity synthetic subject, the acceptance-run scene (torch port
of ``selfreconcode_tpu/data/synthetic_subject.py``).

`make_synthetic_scene` (dataset.py) draws disk masks: enough to smoke the
optimizer, useless for judging reconstruction.  This module renders a
PeopleSnapshot-style subject from the watertight `synthetic_body_model`
(6890 vertices, SMPL schema): a self-rotating clothed person, Lambert-shaded
with a procedural canonical-space albedo (so the colour loss has signal),
hard silhouette masks from the port's mesh rasterizer (the mesh kernel on
the card, its plain version on the CPU), and PIFuHD-convention camera-space
normal maps.

Ground truth built in: the `smpl_rec.npz` poses describe the underlying body
(what a pose estimator would output) while the rendered surface wears a
smooth clothing displacement on top, the residual the translator MLP exists
to learn (reference model/Deformer.py:43-76).  The clothed template is saved
as `gt_mesh.npz` for Chamfer evaluation.

Layout written (what SceneDataset reads): imgs/%d.png masks/%d.png
normals/%d.png camera.npz smpl_rec.npz gt_mesh.npz, then
subject_manifest.json and subject_done.json.

Two deviations from the JAX generator:
  * the manifest is written last.  JAX writes it before the frames
    (synthetic_subject.py:156), so an interrupted regeneration leaves a
    dataset marked as matching with frames of two runs.  Here a manifest
    and a done-marker that do not match are removed before the first frame
    is written, and both are written after the last; frames are skipped
    only when a complete earlier run with the same parameters left them;
  * the 2.6 m camera distance is in every frame's `trans`, not in the
    camera's T (the convention of the port's scene, dataset.py), and the
    light moves with it.  Camera-space geometry, and so every pixel, stays
    the same, while the inference's offset-only camera (at the mean trans)
    sits outside the body.
The JAX generator's raster-capacity ladder is gone: the port's rasterizer
has no capacity and drops no face.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import NamedTuple

import cv2
import numpy as np
import torch

from ..models.smpl import SMPLModel, smpl_forward, smpl_tmp_apose
from ..models.synthetic_body import synthetic_body_model
from ..ops.rasterize import rasterize_mesh
from ..render.camera import Camera, cam_pos, make_camera
from ..utils.meshops import vertex_normals

DISTANCE = np.array([0.0, 0.0, 2.6], np.float32)   # camera to body, in trans
CAM_T = np.array([0.0, 0.18, 0.0], np.float32)     # centres the body
QUAT = np.array([1.0, 0.0, 0.0, 0.0], np.float32)


def subdiv_topology(faces: np.ndarray, n_verts: int):
    """One midpoint-subdivision level: returns (edges (E,2) int, faces4
    (4F,3) int).  New vertex i of the level sits at the midpoint of
    edges[i] and gets index n_verts+i; the surface is unchanged (planar
    split): this only bounds the projected triangle size.
    """
    F = faces.shape[0]
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    uniq, inv = np.unique(np.sort(e, 1), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    m01, m12, m20 = (inv[:F] + n_verts, inv[F:2 * F] + n_verts,
                     inv[2 * F:] + n_verts)
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    faces4 = np.concatenate([
        np.stack([v0, m01, m20], 1), np.stack([v1, m12, m01], 1),
        np.stack([v2, m20, m12], 1), np.stack([m01, m12, m20], 1)])
    return uniq.astype(np.int32), faces4.astype(np.int32)


def clothing_offsets(verts: np.ndarray, normals: np.ndarray,
                     amp: float = 0.012, seed: int = 0) -> np.ndarray:
    """Smooth outward displacement field: base inflation + low-frequency
    wrinkle modes, tapered to zero on head/hands/feet (cloth, not skin)."""
    rng = np.random.default_rng(seed)
    y = verts[:, 1]
    # torso/limb taper: 1 inside the clothed band, 0 at extremities
    band = np.clip((y + 0.95) / 0.15, 0.0, 1.0) * np.clip((0.45 - y) / 0.15,
                                                          0.0, 1.0)
    wave = np.zeros(len(verts))
    for _ in range(3):
        f = rng.normal(0, 4.0, 3)
        ph = rng.uniform(0, 2 * np.pi)
        wave += np.sin(verts @ f + ph)
    d = amp * band * (1.0 + 0.35 * wave)
    return (d[:, None] * normals).astype(np.float32)


def subject_trajectory(n_frames: int, seed: int = 0):
    """The estimator's (underlying body's) poses (F, 24, 3) and the trans
    (F, 3) without the camera distance: a full self-turn, limb swing, hip
    sway and estimation noise."""
    rng = np.random.default_rng(seed + 7)
    t = np.linspace(0.0, 1.0, n_frames, endpoint=False)
    poses = np.tile(smpl_tmp_apose(1)[None], (n_frames, 1, 1)).astype(
        np.float32)
    poses[:, 0, 1] = 2.0 * np.pi * t                      # full turn
    swing = 0.25 * np.sin(2 * np.pi * 6 * t)
    poses[:, 16, 2] += 0.3 * swing                         # shoulders
    poses[:, 17, 2] -= 0.3 * swing
    poses[:, 18, 1] += 0.4 * swing                         # elbows
    poses[:, 19, 1] -= 0.4 * swing
    poses[:, 1, 0] += 0.08 * np.sin(2 * np.pi * 3 * t)     # hips
    poses[:, 2, 0] -= 0.08 * np.sin(2 * np.pi * 3 * t)
    poses += rng.normal(0, 0.01, poses.shape).astype(np.float32)  # est. noise
    trans = np.zeros((n_frames, 3), np.float32)
    trans[:, 0] = 0.03 * np.sin(2 * np.pi * 2 * t)
    trans[:, 1] = 0.02 * np.sin(2 * np.pi * 5 * t)
    return poses, trans


def render_topology(canon: np.ndarray, faces: np.ndarray, fx: float,
                    z_min: float):
    """Midpoint-subdivide the render mesh (at most 4 levels) until its
    footprint, the longest edge x focal / nearest depth inflated 1.5x for
    pose deformation, is at most 24 px.  Returns (per-level edge lists,
    render faces, canonical render vertices, footprint)."""
    def foot(cv, ff):
        e = np.concatenate([cv[ff[:, 1]] - cv[ff[:, 0]],
                            cv[ff[:, 2]] - cv[ff[:, 1]],
                            cv[ff[:, 0]] - cv[ff[:, 2]]])
        em = float(np.linalg.norm(e, axis=-1).max())
        return int(np.clip(np.ceil(1.5 * em * fx / z_min) + 2, 8, 64))

    levels, faces_r = [], faces
    while foot(canon, faces_r) > 24 and len(levels) < 4:
        edges, faces_r = subdiv_topology(faces_r, canon.shape[0])
        canon = np.concatenate(
            [canon, 0.5 * (canon[edges[:, 0]] + canon[edges[:, 1]])])
        levels.append(edges)
    return levels, faces_r, canon.astype(np.float32), foot(canon, faces_r)


class SubjectRig(NamedTuple):
    """What every frame of a subject's render shares."""
    cam: Camera            # PeopleSnapshot-like, R = I, T = CAM_T
    clothed: SMPLModel     # the body whose template wears the clothing
    canon0: np.ndarray     # (V, 3) clothed canonical template
    faces0: np.ndarray     # (F, 3) the body's faces
    cloth: np.ndarray      # (V, 3) clothing offsets
    levels: list           # per subdivision level, its (E, 2) edges
    faces: torch.Tensor    # (F_r, 3) render faces
    canon: torch.Tensor    # (V_r, 3) canonical render vertices
    footprint: int         # raster footprint of the render mesh


def clothed_body(n_verts: int = 6890, body_res: int = 72, seed: int = 0):
    """The subject's body wearing its clothing: (the clothed SMPL model,
    its zero-pose vertices (V, 3), which gt_mesh.npz holds, the clothing
    offsets (V, 3))."""
    body = synthetic_body_model(n_verts=n_verts, res=body_res, seed=seed)
    verts0, faces = body.v_template, body.faces
    vn0 = vertex_normals(torch.from_numpy(verts0),
                         torch.from_numpy(faces).long()).numpy()
    cloth = clothing_offsets(verts0, vn0, seed=seed)
    canon0 = (verts0 + cloth).astype(np.float32)
    clothed = SMPLModel(
        v_template=canon0, shapedirs=body.shapedirs, posedirs=body.posedirs,
        j_regressor=body.j_regressor, weights=body.weights, faces=faces,
        parents=body.parents)
    return clothed, canon0, cloth


def subject_rig(H: int, W: int, n_verts: int = 6890, body_res: int = 72,
                seed: int = 0, device="cuda") -> SubjectRig:
    """The body, its clothing, the camera and the subdivided render mesh
    of a subject (``make_synthetic_subject`` renders every frame from it)."""
    dev = torch.device(device)
    clothed, canon0, cloth = clothed_body(n_verts, body_res, seed)
    faces = clothed.faces
    # camera (PeopleSnapshot-like), at the origin of the body's frame apart
    # from the vertical offset; world->cam is p @ R + T with R = I
    fx = fy = float(W)
    cam = make_camera([fx, fy], [W / 2.0, H / 2.0], QUAT, CAM_T, H, W,
                      device=dev)
    z_min = max(float(DISTANCE[2]) - 1.1, 0.5)
    levels, faces_r, canon_r, footprint = render_topology(canon0, faces, fx,
                                                          z_min)
    return SubjectRig(
        cam=cam, clothed=clothed, canon0=canon0, faces0=faces, cloth=cloth,
        levels=[torch.as_tensor(e, device=dev).long() for e in levels],
        faces=torch.as_tensor(faces_r, device=dev).long(),
        canon=torch.as_tensor(canon_r, device=dev), footprint=footprint)


def render_mesh(rig: SubjectRig, pose: torch.Tensor,
                tr: torch.Tensor) -> torch.Tensor:
    """The render mesh's vertices (V_r, 3) posed into one frame: the
    clothed body under pose (24, 3) and trans tr (3,), then subdivided
    (pure planar splits, so refining after posing keeps the surface)."""
    zeros_beta = torch.zeros((1, 10), device=tr.device)
    v = smpl_forward(rig.clothed, zeros_beta, pose.reshape(1, 24, 3))[0][0]
    v = v + tr[None]
    for edges in rig.levels:
        v = torch.cat([v, 0.5 * (v[edges[:, 0]] + v[edges[:, 1]])])
    return v


def make_synthetic_subject(root: str, n_frames: int = 450, H: int = 1080,
                           W: int = 1080, n_verts: int = 6890,
                           body_res: int = 72, seed: int = 0,
                           write_normals: bool = True, verbose: bool = True,
                           device="cuda"):
    """Render and write the subject; returns the scene root.  The frames
    are rendered on `device` (one mesh-kernel launch each on the card);
    there is no CPU fallback for a CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} but CUDA is not available; the "
                           "subject render does not fall back to the CPU")
    rig = subject_rig(H, W, n_verts, body_res, seed, device)
    cam, faces_t, canon = rig.cam, rig.faces, rig.canon
    poses, trans = subject_trajectory(n_frames, seed)
    trans = trans + DISTANCE
    Rf = torch.diag(torch.tensor([-1.0, 1.0, -1.0], device=dev)) @ cam.R.T
    light = torch.tensor([1.5, 2.0, -2.5], device=dev) + torch.as_tensor(
        DISTANCE, device=dev)

    manifest = {"n_frames": n_frames, "H": H, "W": W, "n_verts": n_verts,
                "body_res": body_res, "seed": seed,
                "write_normals": bool(write_normals),
                "renderer": 2}  # v2 = subdivided render mesh, no drops
    mpath = osp.join(root, "subject_manifest.json")
    dpath = osp.join(root, "subject_done.json")
    resume_ok = False
    if osp.isfile(mpath) and osp.isfile(dpath):
        try:
            with open(mpath) as f:
                resume_ok = json.load(f) == manifest
        except (ValueError, OSError):
            resume_ok = False
    if not resume_ok:
        # nothing may claim this root until its last frame is written
        for p in (mpath, dpath):
            if osp.isfile(p):
                os.remove(p)
    for sub in ("imgs", "masks") + (("normals",) if write_normals else ()):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    np.savez(osp.join(root, "camera.npz"), fx=float(W), fy=float(W),
             cx=W / 2.0, cy=H / 2.0, quat=QUAT, T=CAM_T)
    np.savez(osp.join(root, "smpl_rec.npz"), poses=poses, trans=trans,
             shape=np.zeros(10, np.float32), gender="neutral")
    np.savez(osp.join(root, "gt_mesh.npz"), verts=rig.canon0,
             faces=rig.faces0, cloth=rig.cloth)

    def render_frame(pose, tr):
        v = render_mesh(rig, pose, tr)
        frags = rasterize_mesh(cam, v, faces_t, rig.footprint)
        hit = frags.pix_to_face >= 0
        tri = faces_t[frags.pix_to_face.clamp_min(0).long()]
        b = frags.bary[..., :, None]
        vn = vertex_normals(v, faces_t)
        n = (vn[tri] * b).sum(-2)
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-6)
        p = (v[tri] * b).sum(-2)
        pc = (canon[tri] * b).sum(-2)          # canonical-space position
        albedo = 0.5 + 0.45 * torch.stack([
            torch.sin(7.0 * pc[..., 0] + 3.0 * pc[..., 1]),
            torch.sin(5.0 * pc[..., 1] + 1.0),
            torch.sin(6.0 * pc[..., 2] + 2.0 * pc[..., 0])], dim=-1)
        l = light - p
        l = l / torch.linalg.norm(l, dim=-1, keepdim=True).clamp_min(1e-6)
        view = cam_pos(cam) - p
        view = view / torch.linalg.norm(view, dim=-1,
                                        keepdim=True).clamp_min(1e-6)
        nf = torch.where((n * view).sum(-1, keepdim=True) < 0, -n, n)
        shade = 0.35 + 0.65 * (nf * l).sum(-1).clamp(0.0, 1.0)
        img = (albedo * shade[..., None]).clamp(0.0, 1.0)
        img = torch.where(hit[..., None], img, torch.zeros_like(img))
        img8 = (img * 255.0 + 0.5).to(torch.uint8)
        # PIFuHD-convention camera-frame normals: n_cam = flip @ R^T @ n_w
        # (the trainer decodes them with R @ flip)
        ncam = torch.einsum("ij,hwj->hwi", Rf, nf)
        n8 = torch.where(hit[..., None], (ncam * 0.5 + 0.5) * 255.0 + 0.5,
                         torch.zeros_like(ncam)).to(torch.uint8)
        return img8, hit.to(torch.uint8), n8

    for fid in range(n_frames):
        have = [osp.join(root, "imgs/%d.png" % fid),
                osp.join(root, "masks/%d.png" % fid)]
        if write_normals:
            have.append(osp.join(root, "normals/%d.png" % fid))
        if resume_ok and all(osp.exists(p) for p in have):
            continue
        with torch.no_grad():
            img8, m8, n8 = (x.cpu().numpy() for x in render_frame(
                torch.as_tensor(poses[fid], device=dev),
                torch.as_tensor(trans[fid], device=dev)))
        cv2.imwrite(have[0], img8[:, :, ::-1])  # the dataset reads BGR
        cv2.imwrite(have[1], m8 * 255)
        if write_normals:
            cv2.imwrite(have[2], n8[:, :, ::-1])  # stored RGB; cv2 is BGR
        if verbose and fid % 25 == 0:
            print(f"  subject render {fid}/{n_frames}", flush=True)
    # manifest and done-marker after the last frame: only a complete render
    # claims the root
    for p in (mpath, dpath):
        with open(p, "w") as f:
            json.dump(manifest, f)
    return root
