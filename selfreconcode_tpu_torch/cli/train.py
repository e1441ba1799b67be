"""Training CLI of the port (flags of ``selfreconcode_tpu/cli/train.py``).

    python -m selfreconcode_tpu_torch.cli.train --conf configs/config.conf \\
        --data <scene> --save-folder rec --max-epochs 0 --device cuda

The body is the `{gender}_smpl_with_cocoplus_reg.pkl` of the scene's gender
(``models/smpl.py::get_smpl``: models/assets/, then $SMPL_MODEL_DIR), or
the watertight 6890-vertex stand-in with --synthetic-body, or the toy body
with --toy-smpl.  Writes the checkpoints and, once per fine-stage epoch, a
debug dump (``Trainer.save_debug``) into <data>/<save-folder>.  Runs on one
CUDA device and never falls back to the CPU; ``--device cpu`` is for tests.
TF32 is switched off for matmuls and cuDNN at start, so float32 stays
float32.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import time

import numpy as np

# per-stage octree resolutions (the reference's train.py schedule)
RESOLUTIONS = {
    "coarse": [(15, 21, 9), (29, 41, 17), (57, 81, 33), (113, 161, 65),
               (225, 321, 129)],
    "medium": [(19, 25, 13), (37, 49, 25), (73, 97, 49), (145, 193, 97),
               (289, 385, 193)],
    "fine": [(21, 27, 15), (41, 53, 29), (81, 105, 57), (161, 209, 113),
             (321, 417, 225)],
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SelfRecon per-subject avatar "
                                            "optimization (PyTorch + CUDA)")
    p.add_argument("--gpu-ids", nargs="+", type=int, default=None,
                   help="not supported: pick the card with --device")
    p.add_argument("--conf", required=True, help="config file (HOCON)")
    p.add_argument("--data", required=True, help="data root")
    p.add_argument("--model", default=None,
                   help="checkpoint to resume: a port .pt, a reference .pth "
                        "or a JAX .pkl (told apart by content)")
    p.add_argument("--sdf-model", default=None,
                   help="substitute the SDF of this checkpoint (any of the "
                        "three formats, or a bare SDF state_dict .pth) on "
                        "resume; Adam restarts")
    p.add_argument("--model-rm-prefix", nargs="+", default=None,
                   help="accepted for CLI parity (keys carry no prefix)")
    p.add_argument("--save-folder", required=True)
    p.add_argument("--toy-smpl", action="store_true",
                   help="use the synthetic SMPL stand-in (no pkl assets)")
    p.add_argument("--synthetic-body", action="store_true",
                   help="use the watertight 6890-vertex SMPL-schema body "
                        "(models/synthetic_body.py)")
    p.add_argument("--max-epochs", type=int, default=None,
                   help="cap epochs (debug)")
    p.add_argument("--mesh", default=None, help="not supported (one GPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    if args.gpu_ids is not None:
        p.error("--gpu-ids is not supported; choose the card with --device "
                "(e.g. --device cuda:1)")
    if args.mesh is not None:
        p.error("--mesh (data parallel) is not ported yet; the port trains "
                "on one GPU")
    return args


def open_device(name: str):
    """torch.device(name); raises when it names CUDA and there is none (the
    port never falls back to the CPU).  Switches TF32 off for matmuls and
    cuDNN, so float32 stays float32."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} but CUDA is not available; the "
                           "port does not fall back to CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def load_body(args, gender: str):
    """The SMPL model the flags ask for; without a body flag, the pickle
    of this gender (FileNotFoundError when there is none)."""
    if args.synthetic_body:
        from ..models.synthetic_body import synthetic_body_model
        return synthetic_body_model()
    if args.toy_smpl:
        from ..models.smpl import toy_smpl_model
        return toy_smpl_model()
    from ..models.smpl import get_smpl
    return get_smpl(gender)


def main(argv=None, resolutions=None, skinner_res=None, tune=None):
    """CLI entry; returns the Trainer.  The keyword extras are test
    injection points: `resolutions` replaces the octree schedule,
    `skinner_res` the LBS volume size, and `tune(trainer)` runs right before
    the epoch loop and after each stage switch."""
    args = parse_args(argv)
    from ..config import parse_file
    from ..data.dataset import RandomSampler, SceneDataset, batch_iterator
    from ..engine.checkpoint import (load_checkpoint, load_sdf_state,
                                     save_checkpoint)
    from ..engine.trainer import Trainer

    device = open_device(args.device)
    conf = parse_file(args.conf)
    data_root = args.data
    save_root = osp.join(data_root, args.save_folder)
    debug_root = osp.join(save_root, "debug")
    os.makedirs(debug_root, exist_ok=True)
    shutil.copyfile(args.conf, osp.join(save_root, "config.conf"))

    conds = {"deformer": conf.get_int("mlp_deformer.condlen"),
             "renderer": conf.get_int("render_net.condlen")}
    dataset = SceneDataset(data_root, conds)
    print(f"scene data use {dataset.gender} smpl; {dataset.frame_num} frames "
          f"{dataset.H}x{dataset.W}; device {device}", flush=True)
    smpl = load_body(args, dataset.gender)

    res_sched = resolutions or RESOLUTIONS
    kw = {"skinner_res": skinner_res} if skinner_res else {}
    trainer = Trainer(dataset, smpl, conf, res_sched, data_root=data_root,
                      device=device, **kw)
    print("box:", trainer.b_min.tolist(), trainer.b_max.tolist(), flush=True)

    start_epoch = 0
    pose_type = conf.get_int("train.skinner_pose_type")
    multires = conf.get_int("sdf_net.multires")
    if args.model and osp.isfile(args.model):
        print("load model:", args.model, flush=True)
        sdf_sub = None
        if args.sdf_model and osp.isfile(args.sdf_model):
            # a port .pt, a reference .pth (full or a bare SDF state_dict)
            # or a JAX pickle (JAX's cli/train.py:119-132)
            sdf_sub = load_sdf_state(args.sdf_model)
        start_epoch = load_checkpoint(args.model, trainer, sdf_state=sdf_sub)
    else:
        cache = osp.join(data_root,
                         f"initial_sdf_idr_{multires}_{pose_type}_torch.pt")
        info = trainer.initialize_sdf(abs(conf.get_int("train.initial_iters")),
                                      cache_path=cache)
        print("initial sdf:", info, flush=True)
        if not info.get("cached"):
            # the initial iso-surface, for inspection (train.py:129-132)
            from ..utils.meshops import write_mesh
            mc = trainer.discretize_sdf(0.0, resolutions=res_sched["coarse"])
            write_mesh(osp.join(data_root, f"initial_sdf_idr_{multires}_"
                                           f"{pose_type}_torch.ply"),
                       mc.verts, mc.faces)
            print(f"initial mesh: {mc.verts.shape[0]} verts", flush=True)

    if trainer.stage_cfg is None:
        trainer.set_stage("coarse")
    if tune is not None:
        tune(trainer)

    nepoch = conf.get_int("train.nepoch")
    if args.max_epochs is not None:
        nepoch = min(nepoch, args.max_epochs)
    base_lr = conf.get_float("train.learning_rate")
    milestones = [int(m) for m in conf.get_list("train.scheduler.milestones")]
    factor = conf.get_float("train.scheduler.factor")
    medium_at = conf.get_int("train.medium.start_epoch")
    fine_at = conf.get_int("train.fine.start_epoch")
    sampler = RandomSampler(dataset.frame_num, 1, conf.get_bool("train.shuffle"))
    in_fine = False

    for epoch in range(start_epoch, nepoch + 1):
        if medium_at >= 0 and epoch == medium_at:
            save_checkpoint(osp.join(save_root, "coarse.pt"), trainer, epoch)
            trainer.set_stage("medium")
            print("enable medium hierarchical", flush=True)
            if tune is not None:
                tune(trainer)
        if fine_at >= 0 and epoch == fine_at:
            save_checkpoint(osp.join(save_root, "medium.pt"), trainer, epoch)
            trainer.set_stage("fine")
            in_fine = True
            print("enable fine hierarchical", flush=True)
            if tune is not None:
                tune(trainer)
        lr = base_lr * (factor ** sum(1 for m in milestones if epoch >= m))
        t_epoch = time.time()
        # one debug dump per fine epoch, after the step that follows a
        # remesh (the reference arms `draw` once per epoch and save_debug
        # disarms it: train.py:186-187, network.py:447)
        drew = not in_fine
        for di, (fids, batch) in enumerate(
                batch_iterator(dataset, sampler, trainer.stage_cfg.N)):
            t0 = time.time()
            info = trainer.train_step(np.asarray(fids), batch, lr)
            report(trainer, epoch, di, info, time.time() - t0)
            if (not drew and trainer.forward_time
                    % trainer.stage_cfg.remesh_intersect == 1):
                trainer.save_debug(debug_root, np.asarray(fids), batch)
                drew = True
        print(f"epoch {epoch} took {time.time() - t_epoch:.1f}s", flush=True)
        save_checkpoint(osp.join(save_root, "latest.pt"), trainer, epoch + 1)
    print("training done.", flush=True)
    return trainer


def report(trainer, epoch, di, info, dt):
    out = (f"({epoch}/{di}): loss = {info['loss']:.5f}; "
           f"color_loss: {info.get('color_loss', -1):.5f}, "
           f"eikonal_loss: {info.get('grad_loss', -1):.5f}")
    for k in ("normal_loss", "def_loss", "offset_loss", "dct_loss"):
        if k in info:
            out += f" {k}: {info[k]:.5f},"
    out += (f"\n\tpc_sdf_l: {info.get('pc_loss_sdf', -1):.5f}; "
            f"mask_loss: {info.get('pc_mask_loss', -1):.5f}\t")
    if "pc_defconst_loss" in info:
        out += f"defconst_loss: {info['pc_defconst_loss']:.5f}\t"
    P = trainer.rays_per_step()
    out += (f"\n\trayInfo({P},{int(info.get('ray_converged', 0))})\t"
            f"invInfo({P},{int(info.get('inv_ok', 0))})\t"
            f"remesh: {info['remesh']:.3f}\t{dt:.2f}s/it")
    print(out, flush=True)


if __name__ == "__main__":
    main()
