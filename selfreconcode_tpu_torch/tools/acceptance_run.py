"""The measured acceptance flow (port of the repository's
``tools/acceptance_run.sh`` and ``tools/acceptance_followup.sh``):

  (a) render the synthetic subject (``make_synthetic_subject``; a complete
      earlier render with the same parameters is kept, by its manifest);
  (b) train it through the train CLI with --synthetic-body, appending the
      log to <root>/train.log and resuming from <root>/rec/latest.pt when
      there is one;
  (c) infer through the infer CLI (--synthetic-body --nV);
  (d) read rec/errors.txt (maskE);
  (e) pose the clothed ground-truth body into the trainer's canonical pose
      (``canonical_gt``: written as <root>/gt_canonical.npz) and compare the
      inferred template rec/tmp.ply with it (``compare_meshes``): Chamfer
      and normal consistency;
  (f) report the per-stage rates from the log (``accept_report``) and
      project them onto configs/config.conf's schedule at 450 frames.

    python -m selfreconcode_tpu_torch.tools.acceptance_run [ROOT] [FRAMES] \\
        [EPOCHS] [--conf configs/config.conf] [--h 1080] \\
        [--infer-frames -1] [--device cuda]

Like with like: rec/tmp.ply lives in the template's canonical space, the
body posed into ``smpl_tmp_apose(train.skinner_pose_type)`` (hips +-7 deg
and shoulders +-55 deg with pose type 1), while gt_mesh.npz holds the
clothed body in zero pose.  The JAX flow compares those two directly, so
its Chamfer mostly measures the arms' pose gap; here the ground truth is
posed first, with the body's own skinning and the subject's (zero) shape,
as ``models/skinner.py::build_skinner`` poses the body.

The last line printed is one JSON object: train_s, infer_s, per stage the
median s/step and the epoch seconds, projected_h (and the step counts it is
projected from), maskE mean/max/min, chamfer_l1_mm, chamfer_l2_mm2 and
normal_consistency.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import os.path as osp
import re
import sys
import tempfile
import time

import numpy as np

from . import accept_report as AR
from . import compare_meshes as CM

CONFIGS = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(
    __file__)))), "configs")
PROJECT_FRAMES = 450        # the acceptance subject's length


class _Tee(io.TextIOBase):
    """Writes to every stream it holds (the console and the train log)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def subject_body(root: str):
    """The clothed body of the subject at root, rebuilt from its manifest
    and checked against its gt_mesh.npz: (clothed SMPL model, gt faces)."""
    from ..data.synthetic_subject import clothed_body
    with open(osp.join(root, "subject_manifest.json")) as f:
        man = json.load(f)
    clothed, canon0, _ = clothed_body(man["n_verts"], man["body_res"],
                                      man["seed"])
    gt = np.load(osp.join(root, "gt_mesh.npz"))
    if not np.allclose(canon0, gt["verts"], atol=1e-5):
        raise ValueError(f"{root}: the rebuilt clothed body is not "
                         f"gt_mesh.npz (other body parameters?)")
    return clothed, np.asarray(gt["faces"], np.int64)


def canonical_gt(root: str, pose_type: int) -> str:
    """Pose the clothed GT body into the canonical pose of the template
    (``smpl_tmp_apose(pose_type)``, the subject's shape, the body's pose
    blend shapes and skinning: ``build_skinner``'s posing) and write it as
    <root>/gt_canonical.npz; returns the path."""
    import torch
    from ..models.smpl import smpl_forward, smpl_tmp_apose
    clothed, faces = subject_body(root)
    shape = np.load(osp.join(root, "smpl_rec.npz"))["shape"]
    with torch.no_grad():
        verts = smpl_forward(
            clothed, torch.as_tensor(shape, dtype=torch.float32).reshape(1, -1),
            torch.as_tensor(smpl_tmp_apose(pose_type)).reshape(1, 24, 3))[0][0]
    path = osp.join(root, "gt_canonical.npz")
    np.savez(path, verts=verts.numpy(), faces=faces)
    return path


def read_errors(path: str) -> dict:
    """maskE mean / max / min from errors.txt's header."""
    with open(path) as f:
        head = f.readline()
    m = re.fullmatch(r"maskE, mean: (\S+), max: (\S+), min: (\S+)\s*", head)
    if m is None:
        raise ValueError(f"{path}: not an errors.txt header: {head!r}")
    return dict(zip(("maskE_mean", "maskE_max", "maskE_min"),
                    map(float, m.groups())))


def stage_epochs(conf) -> tuple:
    return (conf.get_int("train.medium.start_epoch"),
            conf.get_int("train.fine.start_epoch"))


def report(root: str, conf, frames: int) -> dict:
    """The run's per-stage rates from <root>/train.log on its own schedule
    (conf's stage epochs, `frames` frames), the accept_report table
    projected onto configs/config.conf's schedule at PROJECT_FRAMES frames,
    and the summary of both."""
    from ..config import parse_file
    samples, epoch_wall = AR.parse_log(osp.join(root, "train.log"))
    medium, fine = stage_epochs(conf)
    rates = AR.stage_rates(samples, epoch_wall, medium, fine, frames)
    ref = parse_file(osp.join(CONFIGS, "config.conf"))
    r_med, r_fine = stage_epochs(ref)
    n_ep = ref.get_int("train.nepoch")
    measured = ", ".join(f"{st} {len(r['dt'])} steps in {r['epochs']} "
                         f"epoch(s)" for st, r in rates.items())
    print(f"projected onto configs/config.conf's schedule at "
          f"{PROJECT_FRAMES} frames from this run's rates ({frames} frames; "
          f"{measured}):", flush=True)
    total_s = AR.print_report(rates, PROJECT_FRAMES, r_med, r_fine, n_ep)
    sched = AR.schedule_steps(PROJECT_FRAMES, r_med, r_fine, n_ep)
    return {
        "stages": {st: {"median_s_per_step": (float(np.median(r["dt"]))
                                              if r["dt"].size else None),
                        "s_per_step_from_epochs": r["rate"],
                        "epoch_s": [s for _, s in r["epoch_s"]]}
                   for st, r in rates.items()},
        "projected_h": total_s / 3600.0,
        "projected_steps": {st: n * s for st, (n, s) in sched.items()},
        "projected_from": {st: len(rates[st]["dt"]) for st in AR.STAGES}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=osp.join(
        tempfile.gettempdir(), "srtpu_accept"))
    ap.add_argument("frames", nargs="?", type=int, default=450)
    ap.add_argument("epochs", nargs="?", type=int, default=None,
                    help="--max-epochs of the train CLI (default: the "
                         "config's nepoch)")
    ap.add_argument("--conf", default=osp.join(CONFIGS, "config.conf"))
    ap.add_argument("--h", type=int, default=1080,
                    help="the subject's height and width in pixels")
    ap.add_argument("--infer-frames", type=int, default=-1,
                    help="the infer CLI's --frames (-1: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None, resolutions=None, skinner_res=None, tune=None) -> dict:
    """Entry point; returns the summary (the last line printed).  The
    keyword extras are the train CLI's test hooks (``cli.train.main``);
    `resolutions` also reaches the infer CLI."""
    from ..cli import infer as icli
    from ..cli import train as tcli
    from ..cli.train import open_device
    from ..config import parse_file
    from ..data.synthetic_subject import make_synthetic_subject

    args = parse_args(argv)
    open_device(args.device)
    root, rec = args.root, osp.join(args.root, "rec")
    conf = parse_file(args.conf)

    print(f"=== subject ({args.frames} frames, {args.h}^2) ===", flush=True)
    t0 = time.perf_counter()
    make_synthetic_subject(root, n_frames=args.frames, H=args.h, W=args.h,
                           device=args.device)
    subject_s = time.perf_counter() - t0

    argv_t = ["--conf", args.conf, "--data", root, "--save-folder", "rec",
              "--synthetic-body", "--device", args.device]
    if args.epochs is not None:
        argv_t += ["--max-epochs", str(args.epochs)]
    if osp.isfile(osp.join(rec, "latest.pt")):
        argv_t += ["--model", osp.join(rec, "latest.pt")]
    print("=== training ===", flush=True)
    t0 = time.perf_counter()
    with open(osp.join(root, "train.log"), "a") as log, \
            contextlib.redirect_stdout(_Tee(sys.stdout, log)):
        tcli.main(argv_t, resolutions=resolutions, skinner_res=skinner_res,
                  tune=tune)
    train_s = time.perf_counter() - t0
    print(f"TRAIN WALL-CLOCK: {train_s:.1f}s", flush=True)

    print("=== inference ===", flush=True)
    t0 = time.perf_counter()
    icli.main(["--rec-root", rec, "--synthetic-body", "--nV", "--frames",
               str(args.infer_frames), "--device", args.device],
              resolutions=resolutions)
    infer_s = time.perf_counter() - t0
    print(f"INFER WALL-CLOCK: {infer_s:.1f}s", flush=True)

    print("=== metrics ===", flush=True)
    errors = read_errors(osp.join(rec, "errors.txt"))
    gt = canonical_gt(root, conf.get_int("train.skinner_pose_type"))
    mesh = CM.compare(CM.load_mesh(osp.join(rec, "tmp.ply")),
                      CM.load_mesh(gt))
    print(f"errors.txt: {errors}; rec/tmp.ply vs gt_canonical.npz: {mesh}",
          flush=True)
    n_frames = len(os.listdir(osp.join(root, "imgs")))
    out = {"subject_s": subject_s, "train_s": train_s, "infer_s": infer_s,
           **report(root, conf, n_frames), **errors,
           **{k: mesh[k] for k in ("chamfer_l1_mm", "chamfer_l2_mm2",
                                   "normal_consistency")}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
