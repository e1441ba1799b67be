"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile   # + one more step under torch.profiler

Phases:
  1. device: the card's name and power limit (nvidia-smi) and torch's view;
  2. build: nvcc builds the splat kernels from csrc/splat.cu;
  3. main path: a 12-frame 512x512 synthetic scene through
     ``selfreconcode_tpu_torch.cli.train.main`` with configs/config.conf at
     full width (toy SMPL body, random weights from a seed), --max-epochs 0:
     skinner build, 1200 IGR iterations, remesh, 4 coarse steps, checkpoint.
     The kernels' launch counters are zeroed right before and read right
     after; both kernels must have run on that path;
  4. kernel vs plain: each kernel against its plain PyTorch version on the
     card at shape A (1080x1080 frame, 134k points on a body-sized shell,
     radius 0.0041) and shape B (the trained template deformed into frame 0
     of the 512x512 scene, radius 0.006), with median times over 25 runs;
  5. the kernels' JSON line, then the device JSON line last.

Imports nothing of JAX.  Exits nonzero when any phase fails or no CUDA card
is present; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = osp.dirname(osp.abspath(__file__))
FWD_TOL = 1e-4          # accumulator: |err| <= FWD_TOL * max(1, |acc|).  A
                        # pixel sums up to ~1000 float32 log1p terms of size
                        # <= 11.5 in another order than the plain version
                        # (index_add_); at |acc| ~ 250 one ulp is 1.5e-5, so
                        # a pure absolute 1e-4 is out of reach there.
MASK_TOL = 1e-6         # mask 1 - exp(acc), absolute
BWD_TOL = 1e-4          # per-point gradient, relative to max|g|


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this smoke run needs an "
                         "NVIDIA GPU (there is no CPU fallback)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase(1, f"torch {torch.__version__} cuda {torch.version.cuda}; "
             f"device 0 = {torch.cuda.get_device_name(0)}; "
             f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def shell_points(n, axes, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * np.asarray(axes)).astype(np.float32)


def time_ms(fn, runs=25, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare_kernels(label, cam, pts, radius, seed):
    """Kernel vs plain on the card at one shape; returns a result dict."""
    import torch
    from selfreconcode_tpu_torch.ops import splat_kernels as SK
    from selfreconcode_tpu_torch.ops.rasterize import (splat_bins,
                                                       splat_cell_size)
    from selfreconcode_tpu_torch.render.camera import transform_points_screen

    H, W = cam.H, cam.W
    r_pix = radius * W / 2.0
    with torch.no_grad():
        s = transform_points_screen(cam, pts)
        col, row = s[:, 0].contiguous(), s[:, 1].contiguous()
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
        b = splat_bins(col, row, s[:, 2], valid, r_pix, H, W,
                       splat_cell_size(r_pix, 9))
        r2_inv = 1.0 / float(r_pix * r_pix)
        args = (col, row, b.entries, b.cell_ids, b.starts, b.counts)
        gen = torch.Generator(device=pts.device).manual_seed(seed)
        cot = torch.randn((b.hp, b.wp), generator=gen, device=pts.device)

        acc_k = SK.splat_fwd(*args, b.cs, b.ncx, b.hp, b.wp, r2_inv)
        acc_p = SK.splat_fwd_plain(*args, b.cs, b.ncx, b.hp, b.wp, r2_inv)
        g_k = SK.splat_bwd(*args, cot, b.cs, b.ncx, r2_inv)
        g_p = SK.splat_bwd_plain(*args, cot, b.cs, b.ncx, r2_inv)
        torch.cuda.synchronize()

        def per_point(g):
            out = torch.zeros((4 * col.shape[0], 2), device=g.device)
            out[b.entries.long()] = g
            return out.reshape(4, -1, 2).sum(0)

        fwd_err = float(((acc_k - acc_p).abs()
                         / acc_p.abs().clamp_min(1.0)).max())
        mask_err = float((torch.exp(acc_k) - torch.exp(acc_p)).abs().max())
        gk, gp = per_point(g_k), per_point(g_p)
        gmax = float(gp.abs().max())
        bwd_err = float((gk - gp).abs().max())
        out = {
            "shape": label, "n_pts": int(pts.shape[0]),
            "entries": int(b.entries.numel()),
            "active_cells": int(b.cell_ids.numel()),
            "max_occupancy": int(b.counts.max()),
            "fwd_max_err": fwd_err, "mask_max_abs_err": mask_err,
            "bwd_max_abs_err": bwd_err,
            "bwd_max_abs_g": gmax,
            "fwd_ms": time_ms(lambda: SK.splat_fwd(
                *args, b.cs, b.ncx, b.hp, b.wp, r2_inv)),
            "fwd_plain_ms": time_ms(lambda: SK.splat_fwd_plain(
                *args, b.cs, b.ncx, b.hp, b.wp, r2_inv)),
            "bwd_ms": time_ms(lambda: SK.splat_bwd(
                *args, cot, b.cs, b.ncx, r2_inv)),
            "bwd_plain_ms": time_ms(lambda: SK.splat_bwd_plain(
                *args, cot, b.cs, b.ncx, r2_inv)),
        }
    print(f"  {label}: {json.dumps(out)}", flush=True)
    if not (fwd_err <= FWD_TOL and mask_err <= MASK_TOL):
        raise AssertionError(f"{label}: forward kernel disagrees with the "
                             f"plain version: acc {fwd_err} > {FWD_TOL} "
                             f"or mask {mask_err} > {MASK_TOL}")
    if not bwd_err <= BWD_TOL * gmax:
        raise AssertionError(f"{label}: backward kernel disagrees with the "
                             f"plain version: {bwd_err} > {BWD_TOL} * {gmax}")
    return out


def main_path(workdir):
    """Drive the port's training CLI once; returns (trainer, seconds)."""
    import numpy as np
    import torch
    from selfreconcode_tpu_torch.cli import train as cli
    from selfreconcode_tpu_torch.data.dataset import make_synthetic_scene
    from selfreconcode_tpu_torch.ops import splat_kernels as SK

    scene = osp.join(workdir, "scene")
    make_synthetic_scene(scene, n_frames=12, H=512, W=512)
    argv = ["--conf", osp.join(ROOT, "configs", "config.conf"),
            "--data", scene, "--save-folder", "rec", "--toy-smpl",
            "--max-epochs", "0", "--device", "cuda"]
    SK.launches.reset()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = SK.launches.splat_fwd_launches, SK.launches.splat_bwd_launches

    hist = trainer.history
    n_steps = len(hist)
    P = trainer.rays_per_step()
    losses = [h["loss"] for h in hist]
    print(f"  steps {n_steps}; losses {losses}", flush=True)
    print(f"  def_loss at step 0: {hist[0].get('def_loss')}; inv_ok "
          f"{[int(h['inv_ok']) for h in hist]} of P={P}; ray_converged "
          f"{[int(h['ray_converged']) for h in hist]}", flush=True)
    print(f"  launches on the main path: splat_fwd {fwd}, splat_bwd {bwd}",
          flush=True)
    times = trainer.timings
    print(f"  seconds: skinner build {times['skinner']:.3f}, IGR "
          f"{times['igr']:.3f}, remesh {times['remesh']:.3f}, mean step "
          f"{statistics.mean(times['steps']):.3f} (steps "
          f"{[round(t, 3) for t in times['steps']]}), whole run {wall:.1f}",
          flush=True)
    ckpt = osp.join(scene, "rec", "latest.pt")
    if n_steps != 4:
        raise AssertionError(f"expected 4 coarse steps, ran {n_steps}")
    if not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(hist[0]["def_loss"]) > 1e-4:
        raise AssertionError(f"def_loss at step 0 is {hist[0]['def_loss']}")
    if any(int(h["inv_ok"]) != P for h in hist):
        raise AssertionError("inv_ok != P on some step")
    need = 3 * n_steps
    if fwd < need or bwd < need:
        raise AssertionError(f"kernels launched fwd={fwd}, bwd={bwd} times; "
                             f"the main path needs >= {need} each")
    if not osp.isfile(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    return trainer, {"splat_fwd": fwd, "splat_bwd": bwd}


def profile_step(trainer):
    """One more coarse step under torch.profiler: prints the device busy
    share and the top 40 ops by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    fids = np.arange(trainer.stage_cfg.N)
    batch = trainer.dataset.batch_raw(fids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(fids, batch, 1e-4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()

    # kernel events only: an op's row repeats its kernels' device time
    busy_ms = sum(e.self_device_time_total for e in avg
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"  profiled step: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%)",
          flush=True)
    print(avg.table(sort_by="self_device_time_total", row_limit=40),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after phase 3, profile one more training step")
    args = ap.parse_args(argv)

    card = device_phase()
    import torch
    from selfreconcode_tpu_torch.ops import splat_kernels as SK
    from selfreconcode_tpu_torch.render.camera import make_camera

    t0 = time.perf_counter()
    SK.build(verbose=True)
    SK._load()
    phase(2, f"built {SK.library_path().relative_to(ROOT)} in "
             f"{time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        phase(3, "main path: cli.train.main on a 12-frame 512x512 scene")
        trainer, launched = main_path(work)
        if args.profile:
            profile_step(trainer)
        with torch.no_grad():
            pts_b = trainer.deformed_template([0])[0]
        cam_b = trainer.camera()

    phase(4, f"kernel vs plain on the card ({card})")
    H = W = 1080
    cam_a = make_camera([0.9 * W] * 2, [W / 2, H / 2], [1, 0, 0, 0],
                        [0, 0, 2.5], H, W, device=dev)
    pts_a = torch.tensor(shell_points(134000, (0.18, 0.75, 0.11), 0),
                         device=dev)
    res_a = compare_kernels("A 1080x1080 134k pts r=0.0041", cam_a, pts_a,
                            0.0041, 1)
    res_b = compare_kernels(f"B 512x512 {pts_b.shape[0]} pts r=0.006",
                            cam_b, pts_b, 0.006, 2)

    src = "selfreconcode_tpu_torch/csrc/splat.cu"
    kernels = [
        {"name": "splat_fwd", "route": "cuda", "source": src,
         "replaces": "selfreconcode_tpu/ops/pallas_raster.py:231",
         "launches": launched["splat_fwd"],
         "max_abs_err": max(res_a["mask_max_abs_err"],
                            res_b["mask_max_abs_err"]),
         "ms": res_b["fwd_ms"], "plain_ms": res_b["fwd_plain_ms"]},
        {"name": "splat_bwd", "route": "cuda", "source": src,
         "replaces": "selfreconcode_tpu/ops/pallas_raster.py:287",
         "launches": launched["splat_bwd"],
         "max_abs_err": max(res_a["bwd_max_abs_err"],
                            res_b["bwd_max_abs_err"]),
         "ms": res_b["bwd_ms"], "plain_ms": res_b["bwd_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
