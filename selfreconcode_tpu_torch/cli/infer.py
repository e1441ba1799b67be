"""Inference CLI of the port (flags of ``selfreconcode_tpu/cli/infer.py``).

    python -m selfreconcode_tpu_torch.cli.infer --rec-root <scene>/rec \\
        --frames 2 --device cuda

Reads ``<rec-root>/latest.pt`` (the port's checkpoint) and the scene one
level up, and writes what the reference's infer.py writes: ``tmp.ply``
(the template at the coarse resolutions), ``meshs/%d.npy`` (deformed
vertices), ``meshs/%d.png`` (Phong render), ``def1meshs/%d.png``
(translator-only render), ``colors/%d.png`` (colour net), an mp4 per image
folder unless ``--nV``, and ``errors.txt`` with the per-frame mask-IoU
error (rewritten every 20 frames, so an interrupted run leaves valid
statistics).  The body flags are the train CLI's (``cli/train.py::
load_body``).  Runs on one CUDA device and never falls back to the CPU;
``--device cpu`` is for tests.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SelfRecon inference "
                                            "(PyTorch + CUDA)")
    p.add_argument("--gpu-ids", nargs="+", type=int, default=None,
                   help="not supported: pick the card with --device")
    p.add_argument("--batch-size", default=1, type=int,
                   help="frames read and inferred per group")
    p.add_argument("--rec-root", required=True,
                   help="training output folder (config.conf, latest.pt)")
    p.add_argument("--frames", default=-1, type=int,
                   help="number of frames to infer (-1: all)")
    p.add_argument("--nV", action="store_true", help="not save video")
    p.add_argument("--nI", action="store_true", help="not save image")
    p.add_argument("--C", action="store_true", help="overlay on gt img")
    p.add_argument("--nColor", action="store_true")
    p.add_argument("--toy-smpl", action="store_true",
                   help="use the synthetic SMPL stand-in (no pkl assets)")
    p.add_argument("--synthetic-body", action="store_true",
                   help="use the watertight 6890-vertex SMPL-schema body "
                        "(models/synthetic_body.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    if args.gpu_ids is not None:
        p.error("--gpu-ids is not supported; choose the card with --device "
                "(e.g. --device cuda:1)")
    if args.nV and args.nI:
        p.error("--nV and --nI together leave nothing to write")
    return args


def main(argv=None, resolutions=None):
    """CLI entry; returns a summary dict: template seconds and size,
    per-frame stats, the mask errors, and the trainer (holding the inference
    template).  `resolutions` replaces the octree schedule (a test injection
    point)."""
    args = parse_args(argv)
    import cv2
    import torch
    from ..config import parse_file
    from ..data.dataset import SceneDataset
    from ..engine.checkpoint import load_checkpoint
    from ..engine.inference import make_infer_fn
    from ..engine.trainer import Trainer
    from ..utils.meshops import write_mesh
    from .train import RESOLUTIONS, load_body

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} but CUDA is not "
                           "available; the port does not fall back to CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rec_root = args.rec_root
    conf = parse_file(osp.join(rec_root, "config.conf"))
    data_root = osp.normpath(osp.join(rec_root, osp.pardir))
    conds = {"deformer": conf.get_int("mlp_deformer.condlen"),
             "renderer": conf.get_int("render_net.condlen")}
    dataset = SceneDataset(data_root, conds)
    res_sched = resolutions or RESOLUTIONS
    trainer = Trainer(dataset, load_body(args, dataset.gender), conf,
                      res_sched, data_root=data_root, device=device)
    ckpt = osp.join(rec_root, "latest.pt")
    print("load model:", ckpt, flush=True)
    load_checkpoint(ckpt, trainer)
    if trainer.stage_cfg is None:
        trainer.set_stage("coarse")

    # the inference template: a remesh at the stage's resolutions; tmp.ply
    # holds the template at the coarse ones (infer.py:47-53,116-119)
    t0 = time.perf_counter()
    nv_t, nf_t = trainer.remesh(1.0)
    template_s = time.perf_counter() - t0
    coarse = tuple(tuple(r) for r in res_sched["coarse"])
    if trainer.stage_cfg.resolutions == coarse:
        ply_v, ply_f = trainer.tmp.verts, trainer.tmp.faces
    else:
        mc = trainer.discretize_sdf(1.0, resolutions=coarse)
        ply_v, ply_f = mc.verts, mc.faces
    write_mesh(osp.join(rec_root, "tmp.ply"), ply_v, ply_f)
    print(f"template: {nv_t} verts, {nf_t} faces in {template_s:.3f} s; "
          f"tmp.ply written", flush=True)

    H, W = dataset.H, dataset.W
    for sub in ("colors", "meshs", "def1meshs"):
        os.makedirs(osp.join(rec_root, sub), exist_ok=True)
    writers = {}
    if not args.nV:
        fourcc = cv2.VideoWriter.fourcc(*"mp4v")
        subs = ("meshs", "def1meshs") + (() if args.nColor else ("colors",))
        for sub in subs:
            writers[sub] = cv2.VideoWriter(
                osp.join(rec_root, sub, "video.mp4"), fourcc, 30.0, (W, H))

    infer_frame = make_infer_fn(trainer, notcolor=args.nColor)
    n_frames = dataset.frame_num if args.frames < 0 else min(
        args.frames, dataset.frame_num)
    mask_errors = -1.0 * np.ones(dataset.frame_num)
    bank, tmp = trainer.bank, trainer.tmp
    frames = []

    def to_u8(img):
        return np.clip(img.cpu().numpy() * 255, 0, 255).astype(np.uint8)

    bs = max(1, args.batch_size)
    for lo in range(0, n_frames, bs):
        fids = list(range(lo, min(lo + bs, n_frames)))
        fds = [dataset.frame_data(fid) for fid in fids]
        masks = [torch.as_tensor(fd["mask"], device=device).float()
                 for fd in fds]
        for fid, fd, out in zip(fids, fds,
                                infer_frame.batched(bank, tmp, fids, masks)):
            mask_errors[fid] = float(out["mask_err"])
            frames.append({"fid": fid, "mask_err": mask_errors[fid],
                           **out["stats"]})
            hit = out["hit"].cpu().numpy()
            mesh_img = to_u8(out["mesh_img"])
            def1_img = to_u8(out["def1_img"])
            if args.C:
                mesh_img = np.where(hit[..., None], mesh_img, fd["img"])
            np.save(osp.join(rec_root, "meshs/%d.npy" % fid),
                    out["def_verts"].cpu().numpy())
            if not args.nI:
                cv2.imwrite(osp.join(rec_root, "meshs/%d.png" % fid),
                            mesh_img)
                cv2.imwrite(osp.join(rec_root, "def1meshs/%d.png" % fid),
                            def1_img)
            if "meshs" in writers:
                writers["meshs"].write(mesh_img)
                writers["def1meshs"].write(def1_img)
            if "color_img" in out:
                # colour-net output is BGR like the training images
                color = to_u8(out["color_img"])
                if args.C:
                    color = np.where(hit[..., None], color, fd["img"])
                if not args.nI:
                    cv2.imwrite(osp.join(rec_root, "colors/%d.png" % fid),
                                color)
                if "colors" in writers:
                    writers["colors"].write(color)
            if fid % 20 == 0:
                print(f"frame {fid}/{n_frames} maskE={mask_errors[fid]:.4f}",
                      flush=True)
                write_errors(rec_root, mask_errors)

    for wv in writers.values():
        wv.release()
    mean_e = write_errors(rec_root, mask_errors)
    print("errors.txt written; mean maskE =", mean_e, flush=True)
    return {"template_s": template_s, "template_verts": nv_t,
            "template_faces": nf_t, "frames": frames,
            "mask_errors": mask_errors, "trainer": trainer}


def write_errors(rec_root: str, mask_errors: np.ndarray) -> float:
    """errors.txt in the reference format (infer.py:172-181): a header with
    mean/max/min over the evaluated frames, then one `i: err` line per frame
    (unevaluated frames carry the -1 sentinel)."""
    sel = mask_errors >= 0.0
    with open(osp.join(rec_root, "errors.txt"), "w") as ff:
        ff.write("maskE, mean: %f, max: %f, min: %f\n" % (
            mask_errors[sel].mean(), mask_errors[sel].max(),
            mask_errors[sel].min()))
        ff.write("maskE:\n")
        ff.write("\n".join("%d: %f" % (i, e)
                           for i, e in enumerate(mask_errors)))
    return float(mask_errors[sel].mean())


if __name__ == "__main__":
    main()
