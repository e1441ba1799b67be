"""The reference's side of a run.  From the inputs (the body pickle, the
rendered subject's files, the initial weights and codes, the seeds and the
frames of each step) it builds the skinner and fits its own SDF, all in
plain PyTorch.  The fit runs torch's deterministic algorithms, as the
program's does in set-up: Adam turns the card's non-deterministic atomic
sums into other weights from run to run.  Even so, two code paths' fits
differ by rounding, which 400 Adam steps turn into weights 10-30% apart,
so the steps start from the program's fitted SDF (`sdf_start`), and the
fit is checked by itself: the program's fit against the reference's own by
the surface they miss.  From that SDF the reference makes its own
template, by its own sweep and marching cubes, and steps it; the
program's template is held against it by size and by position.
``tf32`` runs it in TF32 (the control), ``rays_per_frame``
with another ray count (a planted fault: half of the batch left out)."""
from __future__ import annotations

import dataclasses
import os.path as osp
from contextlib import contextmanager
from typing import Dict, List

import cv2
import numpy as np
import torch

from .camera import ang_threshold, make_camera
from .igr_init import igr_pretrain
from .mathops import dct_null_space
from .remesh import remesh, vertex_normals
from .skinner import build_skinner
from .smpl import load_smpl_pickle, smpl_tmp_apose
from .step import Nets, draw_noise, stage_from_conf, step


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0x0FFF)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Products(torch.overrides.TorchFunctionMode):
    """Matrix products with their float32 operands rounded to TF32 and
    float32 accumulation: what TF32 mode does on the card, on any device."""
    PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.addmm, torch.einsum,
                torch.nn.functional.linear, torch.Tensor.__matmul__,
                torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            def rnd(a):
                if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
                    # rounded forward; the products of the backward pass
                    # come through this mode again and round there
                    return a + (to_tf32(a.detach()) - a).detach()
                if isinstance(a, (list, tuple)):
                    return type(a)(rnd(b) for b in a)
                return a
            args = tuple(rnd(a) for a in args)
        return func(*args, **kwargs)


@contextmanager
def deterministic():
    """torch's deterministic algorithms, switched back as they were after
    (warn_only: an op without one runs as it is)."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


@contextmanager
def precision(tf32: bool, device):
    """float32 as the configuration states it (TF32 off), or, for the
    control, TF32: the card's own mode on CUDA, rounded operands on the
    CPU."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if tf32 and torch.device(device).type != "cuda":
            with _TF32Products():
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


MISS_M = 0.01      # a body vertex the fitted SDF misses: |sdf| over 1 cm


@torch.no_grad()
def fit_misses(sdf_net, verts) -> float:
    """The share of the body's vertices where |sdf| > MISS_M (the fit's
    quality: its weights are chaotic in round-off, its surface is not)."""
    return float((sdf_net(verts, 0.0)[0].abs() > MISS_M).float().mean())


def read_frames(scene: str, fids, device):
    """(colours in [-1, 1] BGR, masks {0, 1}, normals in [-1, 1]) of the
    frames, decoded from the subject's PNGs."""
    imgs, masks, nrms = [], [], []
    for f in fids:
        imgs.append(cv2.imread(osp.join(scene, f"imgs/{f}.png")))
        masks.append((cv2.imread(osp.join(scene, f"masks/{f}.png")) > 0)
                     .any(-1))
        n = cv2.imread(osp.join(scene, f"normals/{f}.png"))
        nrms.append(n[:, :, ::-1] if n is not None else None)
    img = torch.as_tensor(np.stack(imgs), device=device).float()
    gtC = (img / 255.0 - 0.5) * 2.0
    gtM = torch.as_tensor(np.stack(masks), device=device).float()
    if all(n is not None for n in nrms):
        gtN = 2.0 * torch.as_tensor(np.ascontiguousarray(np.stack(nrms)),
                                    device=device).float() / 255.0 - 1.0
    else:
        gtN = torch.zeros_like(gtC)
    return gtC, gtM, gtN


def windows(fids, n_frames: int, size: int) -> np.ndarray:
    """The DCT window of frame ids around each fid, inside the subject."""
    out = np.zeros((len(fids), size), np.int64)
    for b, fid in enumerate(fids):
        s = int(fid) - size // 2
        e = s + size
        if s < 0:
            e, s = e - s, 0
        if e > n_frames:
            s, e = s - (e - n_frames), n_frames
        out[b] = np.clip(max(s, 0) + np.arange(size), 0, n_frames - 1)
    return out


def run(config: dict, stage_name: str, H: int, W: int, body_path: str,
        scene: str, init_nets: Dict[str, torch.Tensor],
        init_codes: Dict[str, torch.Tensor], seed: int, fids: List[List[int]],
        opt_times: int, lr: float, device, sdf_start: Dict[str, torch.Tensor],
        tf32: bool = False, rays_per_frame=None):
    """The reference's state: p0 (before the first step), g1 (the first
    step's gradient as Adam took it), p3 (after the last), the losses, its
    own remesh of sdf_start, the skinner table, its own fitted SDF, and the
    share of the body's vertices that its own fit, sdf_start and the
    initial SDF miss (``fit_misses``).  The steps start from the program's
    fitted SDF (sdf_start) and the reference's own remesh of it."""
    with precision(tf32, device):
        return _run(config, stage_name, H, W, body_path, scene, init_nets,
                    init_codes, seed, fids, opt_times, lr, device, sdf_start,
                    rays_per_frame)


def _run(config, stage_name, H, W, body_path, scene, init_nets, init_codes,
         seed, fids, opt_times, lr, device, sdf_start, rays_per_frame):
    conf = config["conf"]
    body = load_smpl_pickle(body_path)
    rec = np.load(osp.join(scene, "smpl_rec.npz"))
    skinner, body_vs, body_fs = build_skinner(
        body, rec["shape"].astype(np.float32).reshape(-1),
        smpl_tmp_apose(int(conf["train"]["skinner_pose_type"])),
        resolution=tuple(config["skinner_res"]), device=device)
    nets = Nets(conf).to(device)
    nets.load_state_dict(init_nets)
    vs = torch.as_tensor(body_vs, device=device)
    fs = torch.as_tensor(body_fs, device=device).long()
    fit_gen = torch.Generator(device=device).manual_seed(
        int(config["sdf_seed"]) + 1)
    with deterministic():
        igr_pretrain(nets.sdf, vs, vertex_normals(vs, fs),
                     n_iters=int(config["initial_iters"]), generator=fit_gen)
    sdf_fit = {k: v.detach().clone() for k, v in nets.sdf.state_dict().items()}
    fit_miss = fit_misses(nets.sdf, vs)
    nets.sdf.load_state_dict(sdf_start)
    start_miss = fit_misses(nets.sdf, vs)
    unfit = Nets(conf).to(device)
    unfit.load_state_dict(init_nets)
    unfit_miss = fit_misses(unfit.sdf, vs)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)

    cam = np.load(osp.join(scene, "camera.npz"))
    n_frames = int(config["frames"])
    f32 = dict(dtype=torch.float32, device=device)
    bank = {"poses": torch.as_tensor(rec["poses"].reshape(-1, 24, 3), **f32),
            "trans": torch.as_tensor(rec["trans"].reshape(-1, 3), **f32),
            "dcond": init_codes["dcond"].clone(),
            "rcond": init_codes["rcond"].clone(),
            "focal_length": torch.tensor([float(cam["fx"]), float(cam["fy"])],
                                         **f32),
            "princeple_points": torch.tensor([float(cam["cx"]),
                                              float(cam["cy"])], **f32),
            "cam2world_coord_quat": torch.as_tensor(cam["quat"], **f32)
            .reshape(4),
            "world2cam_coord_trans": torch.as_tensor(cam["T"], **f32)
            .reshape(3)}
    bank = {k: v.detach().clone().requires_grad_(True) for k, v in bank.items()}
    opt = torch.optim.Adam(list(nets.parameters()) + list(bank.values()),
                           lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    nw = min(30, n_frames - 1)
    dctnull = dct_null_space(min(10, max(1, nw // 3)), nw)
    cam0 = make_camera(bank["focal_length"].detach(),
                       bank["princeple_points"].detach(),
                       bank["cam2world_coord_quat"].detach(),
                       bank["world2cam_coord_trans"].detach(), H, W,
                       device=device)
    ang = ang_threshold(cam0, 0.5)
    res = config["resolutions"][stage_name]
    stage = stage_from_conf(conf, stage_name, H, W, res, nw,
                            has_normals=osp.isdir(osp.join(scene, "normals")))
    if rays_per_frame is not None:
        stage = dataclasses.replace(stage, rays_per_frame=rays_per_frame)

    b_min = skinner.b_min.cpu().numpy()
    b_max = skinner.b_max.cpu().numpy()
    ext = (b_max - b_min).astype(np.float64)
    own_verts, own_faces, *_ = remesh(nets.sdf, 1.0, stage.resolutions,
                                      b_min, b_max,
                                      np.concatenate([0.5 * ext, 0.5 * ext]),
                                      device)
    verts = own_verts.clone()
    mom = torch.zeros_like(verts)

    def state():
        out = {f"nets.{k}": p.detach().clone()
               for k, p in nets.named_parameters()}
        out.update({f"bank.{k}": v.detach().clone() for k, v in bank.items()})
        return out

    p0 = state()
    p0["template"] = verts.clone()
    g1, losses = {}, []
    for i, f in enumerate(fids):
        gtC, gtM, gtN = read_frames(scene, f, device)
        ft = torch.as_tensor(np.asarray(f), device=device)
        win = torch.as_tensor(windows(f, n_frames, nw), device=device)
        draws = draw_noise(stage, verts.shape[0], gen, device)
        ratios = (1.0, opt_times / 2500.0 + 0.5, 1.0)
        verts, mom, info, g_tmp = step(nets, skinner, stage, dctnull, ang,
                                       opt, bank, verts, mom, gtC, gtM, gtN,
                                       ft, win, ratios, lr, draws)
        opt_times += 1
        losses.append(info["loss"])
        if i == 0:
            g1 = {k: (p.grad.detach().clone() if p.grad is not None
                      else torch.zeros_like(p))
                  for k, p in list((f"nets.{n}", q) for n, q in
                                   nets.named_parameters())
                  + [(f"bank.{n}", q) for n, q in bank.items()]}
            g1["template"] = g_tmp
    p3 = state()
    p3["template"] = verts.clone()
    return {"p0": p0, "g1": g1, "p3": p3, "losses": losses,
            "template": (own_verts, own_faces),
            "skinner_ws": skinner.ws, "sdf_fit": sdf_fit,
            "fit_miss": fit_miss, "start_miss": start_miss,
            "unfit_miss": unfit_miss}


def remesh_from(config: dict, state: dict, device, tf32: bool = False):
    """The reference's remesh of a recorded SDF state and sweep box:
    (verts, faces)."""
    conf = config["conf"]
    with precision(tf32, device):
        nets = Nets(conf).to(device)
        nets.sdf.load_state_dict(state["sdf"])
        verts, faces, *_ = remesh(nets.sdf, state["ratio"],
                                  state["resolutions"], state["b_min"],
                                  state["b_max"], state["grow_left"], device)
    return verts, faces
