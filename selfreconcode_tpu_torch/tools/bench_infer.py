"""Per-frame inference time at a trained state (port of the repository's
``tools/bench_infer.py``): a port checkpoint of a subject restored with the
synthetic body (``profile_step.restored_trainer``), the inference template
remeshed at the stage's resolutions, then ``make_infer_fn`` on --frames
spaced frames: the geometry pass and the colour solve, each synchronized
(``stats``: geom_s, color_s), and the images copied to the host as the
infer CLI does.  The first frame is reported apart (the card's first
launches); the rest give the warm mean and the time of a 450-frame subject.

    python -m selfreconcode_tpu_torch.tools.bench_infer --data <subject> \\
        [--model <subject>/rec/latest.pt] [--conf <subject>/rec/config.conf]
        [--frames 3] [--chunk 65536] [--ncolor] [--no-early-exit]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import os.path as osp
import tempfile
import time

import numpy as np

from .profile_step import restored_trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=osp.join(tempfile.gettempdir(),
                                               "srtpu_accept"))
    ap.add_argument("--model", default=None,
                    help="checkpoint (default <data>/rec/latest.pt)")
    ap.add_argument("--conf", default=None,
                    help="config (default <data>/rec/config.conf)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=65536,
                    help="hit pixels per colour-solve batch")
    ap.add_argument("--ncolor", action="store_true",
                    help="geometry pass only")
    ap.add_argument("--no-early-exit", action="store_true",
                    help="run all 30 surface iterations of the colour solve")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None, resolutions=None) -> list:
    """Entry point; returns the per-frame dicts (fid, s, geom_s, color_s,
    mask_err, hit and converged pixels).  resolutions is a test hook."""
    import torch
    from ..cli.train import open_device
    from ..engine.inference import make_infer_fn

    args = parse_args(argv)
    dev = open_device(args.device)
    conf = args.conf or osp.join(args.data, "rec", "config.conf")
    tr, ds = restored_trainer(args.data, args.model, conf, dev, resolutions)
    t0 = time.perf_counter()
    nv, nf = tr.remesh(1.0)
    print(f"inference template: {nv} verts {nf} faces in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    infer_frame = make_infer_fn(tr, notcolor=args.ncolor, chunk=args.chunk,
                                early_exit=not args.no_early_exit)
    frames = []
    for i in range(args.frames):
        fid = i * max(1, ds.frame_num // args.frames)
        gt_mask = torch.as_tensor(ds.frame_data(fid)["mask"],
                                  device=dev).float()
        t0 = time.perf_counter()
        out = infer_frame(tr.bank, tr.tmp, fid, gt_mask)
        me = float(out["mask_err"])
        for k in ("mesh_img", "def1_img", "color_img"):
            if k in out:
                out[k].cpu()
        dt = time.perf_counter() - t0
        st = out["stats"]
        frames.append({"fid": fid, "s": dt, "mask_err": me, **st})
        print(f"frame {fid}: {dt:.3f} s (geometry {st['geom_s']:.3f} s"
              + (f", colour {st['color_s']:.3f} s, {st['hit_pixels']} hit "
                 f"pixels, {st['converged_pixels']} converged"
                 if "color_s" in st else "")
              + f") maskE={me:.4f}{' (first frame)' if i == 0 else ''}",
              flush=True)
    if len(frames) > 1:
        warm = float(np.mean([f["s"] for f in frames[1:]]))
        print(f"warm mean {warm:.3f} s/frame -> 450 frames ~ "
              f"{warm * 450 / 60:.1f} min", flush=True)
    return frames


if __name__ == "__main__":
    main()
