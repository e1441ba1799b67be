"""Per-pass profile of the training step (port of the repository's
``tools/profile_step.py``, with ``tools/profile_accept.py``'s restore as
--data / --model).

Builds the synthetic trainer (``build_synthetic_trainer``: the 32-frame
disk scene at --h x --h, the toy body, the SDF at its geometric init) at
the production octree resolutions, or restores a checkpoint of a subject
with the synthetic body (--data, --model), remeshes, and times the step's
three passes (``make_train_step``'s ``geom_pass``, ``inner_pass``,
``outer_pass``) on one batch, then the whole ``Trainer.train_step``,
skipping remesh ticks.  Each is reported three ways (``timed``):

  wall    host clock over n back-to-back calls, one synchronize at the end;
  span    CUDA events recorded before the first and after the last call:
          the stream's time from the first call's work to the last's,
          idle gaps included (a host-bound pass has span ~ wall);
  busy    the kernels' own device time of one more call, summed from
          torch.profiler's CUDA events: what the card computed (one call:
          the profiler's trace of a step takes seconds to process).

wall - busy is the host's share of the pass (the device idles meanwhile).
On the CPU (--device cpu, tests only) span and busy are not measured.

    python -m selfreconcode_tpu_torch.tools.profile_step --h 1080 \\
        --stage fine --n 1 --steps 10 [--small] [--rays R] [--device cuda]
    python -m selfreconcode_tpu_torch.tools.profile_step \\
        --data <subject> [--model <subject>/rec/latest.pt] [--stage fine]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import tempfile
import time

import numpy as np
import torch

from ..cli.train import RESOLUTIONS as PROD_RES

SMALL_RES = {k: [(17, 17, 17), (33, 33, 33), (65, 65, 65)]
             for k in ("coarse", "medium", "fine")}
CONF = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(
    __file__)))), "configs", "config.conf")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def busy_ms(fn) -> float:
    """Device ms that the kernels of one call of fn computed: the self
    device time of torch.profiler's CUDA (kernel) events.  CUDA activity
    only: the CPU op events add nothing to the sum and triple the trace's
    processing (an outer pass: 9.7 s against 3.4 s on an H100's host)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:9.2f} ms"


def timed(label: str, fn, n: int, device) -> dict:
    """fn() once (warm), then n back-to-back calls timed by the host clock
    and by CUDA events around them, then one more under torch.profiler.
    Returns {wall_ms, span_ms, busy_ms} per call (the device ones None on
    the CPU) and prints them."""
    fn()
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if cuda:
        ev[1].record()
    _sync(device)
    wall = (time.perf_counter() - t0) * 1e3 / n
    span = ev[0].elapsed_time(ev[1]) / n if cuda else None
    busy = busy_ms(fn) if cuda else None
    share = "" if busy is None else f"  ({100.0 * busy / wall:.1f}% busy)"
    print(f"  {label:<34s} wall {wall:9.2f} ms  span {fmt_ms(span)}  busy "
          f"{fmt_ms(busy)}{share}", flush=True)
    return {"wall_ms": wall, "span_ms": span, "busy_ms": busy}


def make_trainer(args, resolutions=None, tune=None):
    """(trainer, dataset) of the flags, remeshed: the synthetic trainer,
    or with --data the subject's checkpoint restored.  --stage, --n and
    --rays override the stage; tune(trainer) (a test hook) runs last."""
    from ..engine.trainer import build_synthetic_trainer
    t0 = time.perf_counter()
    if args.data:
        tr, ds = restored_trainer(args.data, args.model, args.conf,
                                  args.device, resolutions)
        if args.stage and args.stage != tr.stage_cfg.name:
            tr.set_stage(args.stage)
    else:
        root = args.root or osp.join(tempfile.gettempdir(),
                                     f"srtpu_prof_{args.h}")
        os.makedirs(root, exist_ok=True)
        res = resolutions or (SMALL_RES if args.small else PROD_RES)
        tr, ds = build_synthetic_trainer(root, n_frames=32, H=args.h,
                                         W=args.h, resolutions=res,
                                         device=args.device)
        tr.set_stage(args.stage or "coarse")
    if args.n is not None and tr.stage_cfg.N != args.n:
        tr.override_stage(N=args.n)
    if args.rays:
        tr.override_stage(sample_pix=args.rays)
    if tune is not None:
        tune(tr)
    cfg = tr.stage_cfg
    print(f"setup {time.perf_counter() - t0:.1f} s; stage {cfg.name} "
          f"{cfg.H}x{cfg.W} N={cfg.N} rays={tr.rays_per_step()} "
          f"device {args.device}", flush=True)
    t0 = time.perf_counter()
    nv, nf = tr.remesh(1.0)
    print(f"remesh {time.perf_counter() - t0:.3f} s: {nv} verts {nf} faces",
          flush=True)
    return tr, ds


def restored_trainer(data, model, conf_path, device, resolutions=None):
    """A trainer on the subject at `data` with the synthetic body, restored
    from `model` (default <data>/rec/latest.pt)."""
    from ..config import parse_file
    from ..data.dataset import SceneDataset
    from ..engine.checkpoint import load_checkpoint
    from ..engine.trainer import Trainer
    from ..models.synthetic_body import synthetic_body_model
    conf = parse_file(conf_path)
    ds = SceneDataset(data, {"deformer": conf.get_int("mlp_deformer.condlen"),
                             "renderer": conf.get_int("render_net.condlen")})
    tr = Trainer(ds, synthetic_body_model(), conf, resolutions or PROD_RES,
                 data_root=data, device=device)
    model = model or osp.join(data, "rec", "latest.pt")
    epoch = load_checkpoint(model, tr)
    if tr.stage_cfg is None:
        tr.set_stage("coarse")
    print(f"restored {model}: epoch {epoch}, stage {tr.stage_cfg.name}, "
          f"template {tr.tmp.verts.shape[0]} verts", flush=True)
    return tr, ds


def step_passes(tr, ds):
    """The three passes of one step on frames 0..N-1 as callables, each
    zeroing the gradients first (inner and outer add to .grad), and the
    arguments they share: (geom, inner, outer, outer_args)."""
    from ..engine.trainer import draw_step_noise
    step = tr._get_step_fn()
    cfg = tr.stage_cfg
    f = np.arange(cfg.N) % ds.frame_num
    gtCs, gtMs, gtNs, fids, windows = tr.step_batch(f, ds.batch_raw(f))
    draws = draw_step_noise(cfg, tr.tmp.verts.shape[0], tr.generator,
                            tr.device)
    ratios = (1.0, tr.opt_times / 2500.0 + 0.5, 1.0)
    bank, tmp = tr.bank, tr.tmp

    def zero():
        tr.optimizer.zero_grad(set_to_none=False)

    def geom():
        return step.geom_pass(bank, tmp, gtMs, fids, ratios[1], draws)

    init_pts, sel_ok, idx, mgtMs = geom()

    def inner():
        zero()
        return step.inner_pass(bank, tmp, fids, mgtMs, ratios[1])

    new_tmp = inner()[0]
    binds, rows, cols = step.ray_pixels(idx)
    outer_args = (bank, new_tmp, gtCs, gtNs, fids, init_pts, sel_ok, rows,
                  cols, binds, windows, ratios, draws)

    def outer():
        zero()
        return step.outer_pass(*outer_args)

    return geom, inner, outer, outer_args


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--n", type=int, default=None,
                    help="frames per step (default: the stage's)")
    ap.add_argument("--stage", default=None,
                    help="coarse, medium or fine (default coarse; with "
                         "--data, the checkpoint's)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--small", action="store_true",
                    help="small octree resolutions (a faster remesh)")
    ap.add_argument("--rays", type=int, default=None,
                    help="override sample_pix per frame")
    ap.add_argument("--root", default=None,
                    help="where the synthetic scene is written (default "
                         "<tmp>/srtpu_prof_<h>)")
    ap.add_argument("--data", default=None,
                    help="profile this subject's checkpoint instead")
    ap.add_argument("--model", default=None,
                    help="checkpoint (default <data>/rec/latest.pt)")
    ap.add_argument("--conf", default=CONF)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None, resolutions=None, tune=None) -> dict:
    """Entry point; returns {pass: timed dict} for geom_pass, inner_pass,
    outer_pass, sum and train_step.  resolutions and tune(trainer) are test
    hooks (the octree schedule; sample counts)."""
    from ..cli.train import open_device
    args = parse_args(argv)
    args.device = open_device(args.device)
    tr, ds = make_trainer(args, resolutions, tune)
    geom, inner, outer, _ = step_passes(tr, ds)
    print(f"\npasses (per call; {args.steps} calls back to back):",
          flush=True)
    out = {name: timed(name, fn, args.steps, args.device)
           for name, fn in (("geom_pass", geom), ("inner_pass", inner),
                            ("outer_pass", outer))}
    out["sum"] = {k: (None if any(out[p][k] is None for p in out)
                      else sum(out[p][k] for p in out))
                  for k in ("wall_ms", "span_ms", "busy_ms")}
    s = out["sum"]
    print(f"  {'sum of passes':<34s} wall {s['wall_ms']:9.2f} ms  span "
          f"{fmt_ms(s['span_ms'])}  busy {fmt_ms(s['busy_ms'])}", flush=True)

    cfg = tr.stage_cfg
    fids = np.arange(cfg.N) % ds.frame_num
    batch = ds.batch_raw(fids)

    def train_step():
        if tr.forward_time % cfg.remesh_intersect == 0:
            tr.forward_time += 1        # skip remesh ticks
        tr.train_step(fids, batch, 1e-4)

    print("\nfull train_step (remesh ticks skipped):", flush=True)
    out["train_step"] = timed("train_step", train_step, args.steps,
                              args.device)
    wall = out["train_step"]["wall_ms"]
    print(f"  steady state: {wall:.1f} ms/step ({1e3 / wall:.2f} steps/s)",
          flush=True)
    return out


if __name__ == "__main__":
    main()
