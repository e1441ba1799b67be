"""A/B of the reference-exact variants from a trained stage checkpoint (port
of the JAX package's ``tools/ab_stage_resume.py``).

``ab_convergence`` compares the variants on a short coarse run from
scratch; the medium and fine stages, where the mask error is earned, start
from a stage checkpoint instead.  This tool loads one (``coarse.pt`` /
``medium.pt``, which the train CLI writes at the stage boundaries, or a
reference ``.pth`` or a JAX ``.pkl``: ``load_checkpoint`` tells them apart)
and runs N epochs of a stage once per variant, with the same frame orders
(``RandomSampler`` seed 123 + epoch), the same step noise (a
``torch.Generator`` seeded 42 for each variant) and the config's learning-
rate milestones applied per epoch.  The stage switches (a remesh at its
first step) only when the checkpoint's stage differs.  Reported per
variant: maskE = 1 - the hard mesh-render IoU on spaced frames
(``eval_mask_iou``), the last step's loss, converged-ray fraction, mask and
colour losses, and seconds per step.

    python -m selfreconcode_tpu_torch.tools.ab_stage_resume --root <subject> \\
        --ckpt medium.pt --stage fine --epochs 2 --variants base ref_exact

The subject's run directory is <root>/rec (the config is its config.conf,
the checkpoint <root>/rec/<ckpt>).  Prints a markdown table, then one JSON
line per variant.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import time

import numpy as np

from .ab_convergence import (SAMPLER_SEED, VARIANTS, make_trainer,
                             prepare_variant, result)


def run_variant(label, overrides, args, resolutions=None, skinner_res=None,
                tune=None):
    """Resume the checkpoint and run args.epochs epochs of args.stage."""
    from ..config import parse_file
    from ..data.dataset import RandomSampler, batch_iterator
    from ..engine.checkpoint import load_checkpoint

    conf = parse_file(osp.join(args.root, "rec", "config.conf"))
    ds, tr = make_trainer(args.root, conf, args.device, resolutions,
                          skinner_res)
    epoch0 = load_checkpoint(osp.join(args.root, "rec", args.ckpt), tr)
    if tr.stage_cfg is None or tr.stage_cfg.name != args.stage:
        tr.set_stage(args.stage)
    prepare_variant(tr, label, overrides, tune)
    print(f"[{label}] resumed {args.ckpt} (epoch {epoch0}) -> stage "
          f"{args.stage} overrides={overrides}", flush=True)

    base_lr = conf.get_float("train.learning_rate")
    milestones = [int(m) for m in conf.get_list("train.scheduler.milestones")]
    factor = conf.get_float("train.scheduler.factor")
    infos = []
    t0 = time.perf_counter()
    for ep in range(epoch0, epoch0 + args.epochs):
        lr = base_lr * (factor ** sum(1 for m in milestones if ep >= m))
        sampler = RandomSampler(ds.frame_num, seed=SAMPLER_SEED + ep)
        for fids, batch in batch_iterator(ds, sampler, tr.stage_cfg.N):
            infos.append(tr.train_step(np.asarray(fids), batch, lr))
            if len(infos) % 100 == 0:
                li = infos[-1]
                print(f"  [{label}] step {len(infos)}: loss={li['loss']:.4f} "
                      f"mask={li.get('pc_mask_loss', -1):.4f} "
                      f"rays={li['ray_converged']:.0f}", flush=True)
    res = result(label, tr, ds, infos, time.perf_counter() - t0,
                 args.eval_frames)
    print(f"  [{label}] DONE maskE={res['maskE']:.4f} loss={res['loss']:.4f} "
          f"{res['s_per_it']:.3f} s/it", flush=True)
    return res


def print_table(results, args):
    print(f"\nA/B from {args.ckpt} -> {args.epochs} {args.stage} epochs")
    print("| variant | maskE | loss | ray_frac | mask_loss | color_loss "
          "| s/it |")
    print("|---|---|---|---|---|---|---|")
    for r in results:
        print(f"| {r['label']} | {r['maskE']:.4f} | {r['loss']:.4f} | "
              f"{r['ray_frac']:.3f} | {r['mask_loss']:.4f} | "
              f"{r['color_loss']:.4f} | {r['s_per_it']:.3f} |", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="the subject; its run directory is <root>/rec")
    ap.add_argument("--ckpt", default="medium.pt",
                    help="checkpoint in <root>/rec: a port .pt, a "
                         "reference .pth or a JAX .pkl")
    ap.add_argument("--stage", default="fine",
                    choices=["coarse", "medium", "fine"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--eval-frames", type=int, default=8)
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    default=["base", "ref_exact"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None, resolutions=None, skinner_res=None, tune=None):
    """Entry point; returns the result dicts.  The keyword extras are test
    hooks, as in ``cli.train.main``: the octree schedule, the LBS volume
    size (used only when <root> holds no skinner cache) and tune(trainer),
    run before the variant's fields are set."""
    from ..cli.train import open_device

    args = parse_args(argv)
    args.device = open_device(args.device)
    results = [run_variant(v, VARIANTS[v], args, resolutions, skinner_res,
                           tune) for v in args.variants]
    print_table(results, args)
    for r in results:
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
