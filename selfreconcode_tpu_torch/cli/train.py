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

``--mesh dp=N`` trains data-parallel (``parallel/sharded.py``): the CLI
spawns N processes, rank r on cuda:r over NCCL (``--device cpu``: gloo),
rendezvous through a FileStore in the save folder.  Rank 0 alone builds
the skinner and IGR caches (the others then load them), prints the report
and writes the checkpoints and the debug dump.  A rank that fails fails
the CLI.

``--trace`` records the training step's spans and counters
(``utils/trace.py``) and prints one line at each epoch's end
(``trace_report``).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import re
import shutil
import sys
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
    p.add_argument("--mesh", default=None, metavar="dp=N",
                   help="train data-parallel over N processes, one device "
                        "each (cuda:0..N-1 over NCCL; gloo with --device "
                        "cpu): rays sharded, parameters replicated, one "
                        "gradient all-reduce per step")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--trace", action="store_true",
                   help="record the step's spans and counters and print, at "
                        "each epoch's end, each span's ms per step (duration"
                        " and self), host syncs per step and the surface "
                        "solve's converged rays")
    args = p.parse_args(argv)
    if args.gpu_ids is not None:
        p.error("--gpu-ids is not supported; choose the card with --device "
                "(e.g. --device cuda:1)")
    if args.mesh is not None:
        m = re.fullmatch(r"(?:dp=)?(\d+)", args.mesh)
        if m is None or int(m.group(1)) < 1:
            p.error(f"--mesh takes dp=N with N >= 1, not {args.mesh!r}")
        if args.device not in ("cuda", "cpu"):
            p.error("--mesh places rank r on cuda:r; pass --device cuda (or "
                    "cpu)")
        args.dp = int(m.group(1))
    return args


def check_mesh(args):
    """JAX's conditions on --mesh dp=N (its cli/train.py:101-108): N
    devices, and an image height divisible by N."""
    import torch
    from ..data.dataset import SceneDataset
    n = args.dp
    if args.device == "cuda":
        open_device("cuda")
        found = torch.cuda.device_count()
        if found < n:
            raise ValueError(f"--mesh dp={n} needs {n} devices, found "
                             f"{found} (cuda)")
    height = SceneDataset(args.data, use_native=False).H
    if height % n:
        raise ValueError(f"image height {height} must divide by dp={n} "
                         f"(rows are sharded over the mesh)")


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
    """CLI entry; returns the Trainer (None under --mesh, where rank 0's
    checkpoint is the result).  The keyword extras are test injection
    points: `resolutions` replaces the octree schedule, `skinner_res` the
    LBS volume size, and `tune(trainer)` runs right before the epoch loop
    and after each stage switch (on every rank under --mesh; it must then
    be picklable)."""
    args = parse_args(argv)
    if args.mesh is None:
        return train(args, resolutions, skinner_res, tune)
    check_mesh(args)
    import torch.multiprocessing as mp
    save_root = osp.join(args.data, args.save_folder)
    os.makedirs(save_root, exist_ok=True)
    store = osp.join(save_root, ".dp_store")
    if osp.exists(store):
        os.remove(store)
    try:
        mp.start_processes(_rank_main, nprocs=args.dp, join=True,
                           start_method="spawn",
                           args=(argv, store, resolutions, skinner_res, tune))
    finally:
        if osp.exists(store):
            os.remove(store)
    return None


def _rank_main(rank, argv, store, resolutions, skinner_res, tune):
    """One spawned rank of --mesh dp=N: join the group, train, leave."""
    from .. import parallel as D
    args = parse_args(argv)
    if rank:
        sys.stdout = open(os.devnull, "w")
    setup_s = D.init_dp(rank, args.dp, args.device, store)
    try:
        train(args, resolutions, skinner_res, tune, dp_setup_s=setup_s)
    finally:
        D.shutdown()


def train(args, resolutions=None, skinner_res=None, tune=None,
          dp_setup_s=None):
    """The training run of main; under --mesh one rank's (dp_setup_s: the
    seconds its process group took to set up)."""
    from .. import parallel as D
    from ..config import parse_file
    from ..data.dataset import RandomSampler, SceneDataset, batch_iterator
    from ..engine.checkpoint import (load_checkpoint, load_sdf_state,
                                     save_checkpoint)
    from ..engine.trainer import Trainer
    from ..utils import trace

    name = args.device
    if dp_setup_s is not None and name == "cuda":
        name = f"cuda:{D.rank()}"       # rank r trains on cuda:r
    device = open_device(name)
    conf = parse_file(args.conf)
    data_root = args.data
    save_root = osp.join(data_root, args.save_folder)
    debug_root = osp.join(save_root, "debug")
    if D.is_main():
        os.makedirs(debug_root, exist_ok=True)
        shutil.copyfile(args.conf, osp.join(save_root, "config.conf"))

    conds = {"deformer": conf.get_int("mlp_deformer.condlen"),
             "renderer": conf.get_int("render_net.condlen")}
    res_sched = resolutions or RESOLUTIONS
    kw = {"skinner_res": skinner_res} if skinner_res else {}
    start_epoch = 0
    pose_type = conf.get_int("train.skinner_pose_type")
    multires = conf.get_int("sdf_net.multires")
    # under --mesh rank 0 runs the set-up first and writes the skinner and
    # IGR caches; the other ranks then load them
    with D.main_first():
        dataset = SceneDataset(data_root, conds)
        print(f"scene data use {dataset.gender} smpl; {dataset.frame_num} "
              f"frames {dataset.H}x{dataset.W}; device {device}; frames "
              f"decoded by {dataset.decoder}", flush=True)
        smpl = load_body(args, dataset.gender)
        trainer = Trainer(dataset, smpl, conf, res_sched,
                          data_root=data_root, device=device, **kw)
        print("box:", trainer.b_min.tolist(), trainer.b_max.tolist(),
              flush=True)
        if args.model and osp.isfile(args.model):
            print("load model:", args.model, flush=True)
            sdf_sub = None
            if args.sdf_model and osp.isfile(args.sdf_model):
                # a port .pt, a reference .pth (full or a bare SDF
                # state_dict) or a JAX pickle (JAX's cli/train.py:119-132)
                sdf_sub = load_sdf_state(args.sdf_model)
            start_epoch = load_checkpoint(args.model, trainer,
                                          sdf_state=sdf_sub)
        else:
            cache = osp.join(data_root, f"initial_sdf_idr_{multires}_"
                                        f"{pose_type}_torch.pt")
            info = trainer.initialize_sdf(
                abs(conf.get_int("train.initial_iters")), cache_path=cache)
            print("initial sdf:", info, flush=True)
            if not info.get("cached"):
                # the initial iso-surface, for inspection (train.py:129-132)
                from ..utils.meshops import write_mesh
                mc = trainer.discretize_sdf(0.0,
                                            resolutions=res_sched["coarse"])
                write_mesh(osp.join(data_root, f"initial_sdf_idr_{multires}_"
                                               f"{pose_type}_torch.ply"),
                           mc.verts, mc.faces)
                print(f"initial mesh: {mc.verts.shape[0]} verts", flush=True)
    if dp_setup_s is not None:
        trainer.set_dp()
        trainer.timings["dp_setup"] = dp_setup_s
        print(f"data parallel: rank {D.rank()} of {D.world()} on {device}, "
              f"process group set up in {dp_setup_s:.3f} s", flush=True)

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
    if args.trace:
        trace.read_and_clear()
        trace.enable()

    for epoch in range(start_epoch, nepoch + 1):
        if medium_at >= 0 and epoch == medium_at:
            if D.is_main():
                save_checkpoint(osp.join(save_root, "coarse.pt"), trainer,
                                epoch)
            trainer.set_stage("medium")
            print("enable medium hierarchical", flush=True)
            if tune is not None:
                tune(trainer)
        if fine_at >= 0 and epoch == fine_at:
            if D.is_main():
                save_checkpoint(osp.join(save_root, "medium.pt"), trainer,
                                epoch)
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
                if D.is_main():
                    trainer.save_debug(debug_root, np.asarray(fids), batch)
                drew = True
        print(f"epoch {epoch} took {time.time() - t_epoch:.1f}s", flush=True)
        if args.trace:
            print(trace_report(epoch, trace.read_and_clear()), flush=True)
        if D.is_main():
            save_checkpoint(osp.join(save_root, "latest.pt"), trainer,
                            epoch + 1)
    print("training done.", flush=True)
    return trainer


def trace_report(epoch: int, rec: dict) -> str:
    """The --trace line of an epoch from its record
    (``trace.read_and_clear``): per step, each span's ms as duration/self
    (in the order the spans first started), the host syncs, and the mean
    converged rays of the surface solve before its first iteration and
    after each."""
    n = sum(s["name"] == "train_step" for s in rec["spans"])
    if not n:
        return f"trace epoch {epoch}: no step"
    tot = {}
    for s in sorted(rec["spans"], key=lambda s: s["start"]):
        d, own = tot.get(s["name"], (0.0, 0.0))
        tot[s["name"]] = (d + s["end"] - s["start"], own + s["self"])
    out = (f"trace epoch {epoch} ({n} steps; ms per step, duration/self): "
           + ", ".join(f"{k} {1e3 * d / n:.1f}/{1e3 * own / n:.1f}"
                       for k, (d, own) in tot.items())
           + f"; host_syncs {rec['counters'].get('host_syncs', 0) / n:.1f}"
           f" per step")
    rows = rec["device"].get("solve_converged", [])
    rows = [r for r in rows if len(r) == len(rows[-1])]
    if rows:
        mean = np.mean(rows, axis=0)
        out += "; solve_converged " + " ".join(f"{v:.1f}" for v in mean)
    return out


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
