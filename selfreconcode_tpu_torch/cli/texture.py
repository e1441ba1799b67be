"""Texture CLIs of the port (flags of ``selfreconcode_tpu/cli/texture.py``).

    python -m selfreconcode_tpu_torch.cli.texture prepare --rec-root <scene>/rec --num 120
    python -m selfreconcode_tpu_torch.cli.texture extract --rec-root <scene>/rec

`prepare` (texture_mesh_prepare.py): loads ``<rec-root>/latest.pt`` (any
checkpoint format ``load_checkpoint`` reads, so the dataset holds the
trained camera), deforms the user's UV'd template ``<rec-root>/template/
uvmap.obj`` into --num evenly spaced frames on the device and writes
``tex_predata.npz`` with JAX's keys.  The body flags are the train CLI's.

`extract` (texture_mesh_extract.py without the VideoAvatar/opendr
environment): bakes ``texture.png`` from the frames of ``tex_predata.npz``
(``texture/uv.py``: the mesh kernel once per frame on the card), inpaints
the holes and prints the coverage.

Both run on one CUDA device (``--device``, default cuda) and raise without
one; ``--device cpu`` runs the plain versions (tests).
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys
import time

import numpy as np


def _load_trainer(args, device):
    """The trainer of <rec-root>/config.conf with latest.pt loaded into it
    (JAX's cli/texture.py:19-42)."""
    from ..config import parse_file
    from ..data.dataset import SceneDataset
    from ..engine.checkpoint import load_checkpoint
    from ..engine.trainer import Trainer
    from .train import RESOLUTIONS, load_body

    conf = parse_file(osp.join(args.rec_root, "config.conf"))
    data_root = osp.normpath(osp.join(args.rec_root, osp.pardir))
    conds = {"deformer": conf.get_int("mlp_deformer.condlen"),
             "renderer": conf.get_int("render_net.condlen")}
    dataset = SceneDataset(data_root, conds)
    trainer = Trainer(dataset, load_body(args, dataset.gender), conf,
                      RESOLUTIONS, data_root=data_root, device=device)
    load_checkpoint(osp.join(args.rec_root, "latest.pt"), trainer)
    return trainer, dataset


def prepare(argv=None):
    """Returns {"seconds", "fids", "def_vs_shape"}."""
    parser = argparse.ArgumentParser(description="texture prepare")
    parser.add_argument("--gpu-ids", nargs="+", type=int, default=None,
                        help="not supported: pick the card with --device")
    parser.add_argument("--rec-root", required=True)
    parser.add_argument("--num", type=int, default=120)
    parser.add_argument("--toy-smpl", action="store_true")
    parser.add_argument("--synthetic-body", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    if args.gpu_ids is not None:
        parser.error("--gpu-ids is not supported; choose the card with "
                     "--device (e.g. --device cuda:1)")

    import torch
    from ..models.deformer import deformer_apply
    from ..texture.uv import load_obj_with_uv
    from .train import open_device

    t0 = time.perf_counter()
    device = open_device(args.device)
    trainer, dataset = _load_trainer(args, device)
    obj = osp.join(args.rec_root, "template", "uvmap.obj")
    verts, uvs, faces_v, faces_vt = load_obj_with_uv(obj)
    print(f"uvmap.obj: {len(verts)} verts, {len(faces_v)} faces, "
          f"{len(uvs)} uvs", flush=True)

    n = min(args.num, dataset.frame_num)
    fids = np.linspace(0, dataset.frame_num - 1, n).astype(np.int64)
    bank = trainer.bank
    tverts = torch.as_tensor(verts, device=device)
    binds = torch.zeros(verts.shape[0], dtype=torch.long, device=device)
    with torch.no_grad():
        def_vs = np.stack([deformer_apply(
            trainer.nets.translator, trainer.skinner, tverts, binds,
            bank["dcond"][f:f + 1], bank["poses"][f:f + 1],
            bank["trans"][f:f + 1], 1.0)[0].cpu().numpy() for f in fids])
    cp = dataset.camera_params
    np.savez(osp.join(args.rec_root, "tex_predata.npz"),
             def_vs=def_vs, fids=fids, uvs=uvs, faces_v=faces_v,
             faces_vt=faces_vt,
             focal=cp["focal_length"], princeple=cp["princeple_points"],
             quat=cp["cam2world_coord_quat"],
             T=cp["world2cam_coord_trans"], H=dataset.H, W=dataset.W)
    seconds = time.perf_counter() - t0
    print("tex_predata.npz written:", def_vs.shape, flush=True)
    return {"seconds": seconds, "fids": fids, "def_vs_shape": def_vs.shape}


def load_predata(rec_root: str):
    """(tex_predata.npz's arrays, the baked frames' images RGB float32 in
    [0, 1]), the images read in the dataset's frame order."""
    import cv2
    from ..data.dataset import frame_images

    data = np.load(osp.join(rec_root, "tex_predata.npz"))
    files = frame_images(osp.normpath(osp.join(rec_root, osp.pardir)))
    imgs = [cv2.imread(files[int(fid)])[:, :, ::-1].astype(np.float32)
            / 255.0 for fid in data["fids"]]
    return data, imgs


def extract(argv=None):
    """Returns {"coverage", "bake_s", "frames", "tex_shape", "path"}."""
    parser = argparse.ArgumentParser(description="texture extract")
    parser.add_argument("--rec-root", required=True)
    parser.add_argument("--tex-size", type=int, default=1024)
    parser.add_argument("--save-name", default="texture.png")
    parser.add_argument("--k-best", type=int, default=8,
                        help="per-texel best-viewing-angle slots for the "
                             "median aggregation (1 = weighted mean)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    import cv2
    from ..render.camera import make_camera
    from ..texture.uv import bake_texture, inpaint_texture
    from .train import open_device

    device = open_device(args.device)
    data, imgs = load_predata(args.rec_root)
    cam = make_camera(data["focal"], data["princeple"], data["quat"],
                      data["T"], int(data["H"]), int(data["W"]),
                      device=device)
    t0 = time.perf_counter()
    tex, w = bake_texture(cam, list(data["def_vs"]), imgs, data["faces_v"],
                          data["faces_vt"], data["uvs"],
                          tex_size=args.tex_size, k_best=args.k_best)
    bake_s = time.perf_counter() - t0
    out = inpaint_texture(tex, w)
    path = osp.join(args.rec_root, args.save_name)
    cv2.imwrite(path, out[:, :, ::-1])
    coverage = float((w > 0).mean())
    print("texture written:", path, f"coverage={coverage:.3f}", flush=True)
    return {"coverage": coverage, "bake_s": bake_s,
            "frames": len(data["fids"]), "tex_shape": out.shape,
            "path": path}


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "prepare"
    if cmd == "prepare":
        prepare(sys.argv[2:])
    elif cmd == "extract":
        extract(sys.argv[2:])
    else:
        raise SystemExit(f"unknown subcommand {cmd}")
