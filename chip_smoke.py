"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile   # + one more step under torch.profiler

Phases:
  1. device: the card's name and power limit (nvidia-smi) and torch's view;
  2. build: one nvcc per CUDA source, all started together:
     csrc/splat.cu (the splat kernels) and csrc/mesh_raster.cu (the mesh
     rasterizer);
  3. training path on the real-body schema: the watertight 6890-vertex
     synthetic body is written as ``neutral_smpl_with_cocoplus_reg.pkl``
     (``save_smpl_pickle``) into a directory named by $SMPL_MODEL_DIR; the
     port's ``make_synthetic_subject`` renders a 12-frame 512x512 subject
     of it with images, masks and normal maps (one mesh-kernel launch per
     frame); ``selfreconcode_tpu_torch.cli.train.main`` trains on it with
     configs/config.conf at full width and no body flag, so the body comes
     through ``get_smpl`` -> ``load_smpl_pickle`` (random weights from a
     seed), --max-epochs 0: skinner build, 1200 IGR iterations, remesh, 4
     coarse steps with the normal loss, checkpoint;
  3b. the fine stage at 1080x1080: a 4-frame subject of the same body and
     seed, phase 3's IGR and skinner caches copied into its root (no second
     IGR), and a conf with the medium stage off and the fine stage from
     epoch 0, run with --synthetic-body: 4 fine steps (N = 1, 6144 rays,
     radius 0.0041, octree up to 321x417x225), the CLI's debug dump right
     after the first; prints the dataset's decoder, and when it is the
     native loader (``data/native_loader.py``, built with g++ at first
     use) holds each of the 4 frames (image, mask, normal) bitwise equal
     to cv2's decode and times a cold frame both ways;
  3c. on phase 3b's trainer, 2 steps with rays seeded from rasterized
     fragments (point_inits=False: one mesh-kernel launch per step) and the
     three mesh regularizers on, at config.conf's coarse magnitudes made
     positive (Laplacian 10, edge 10, normal consistency 0.001);
  3d. resume through the checkpoint interchange on phase 3's subject, with
     the train CLI at full width: (a) a reference-format .pth written from
     phase 3's trainer (reference key names, an ``engine.*`` and a
     ``deformer.defs.1.*`` key the loader must drop, the bank at the top
     level with focal +1%), --model on it for one more coarse epoch of 4
     steps: the dataset must hold the file's camera after the load (the
     bank written back); (b) phase 3's latest.pt with --sdf-model a bare SDF
     state_dict .pth (the IGR cache): the SDF must be the file's and Adam
     empty before the first step; each 12 + 12 splat launches;
  3e. the three-stage schedule: phase 3's subject and its IGR and skinner
     caches copied to a new root, a conf whose medium stage starts at
     epoch 1 and fine at epoch 2 (every other key as config.conf), and the
     train CLI with --max-epochs 2: 4 coarse steps (N = 3), 6 medium (N =
     2, radius 0.00465, remesh_intersect 60) and 12 fine (N = 1), a remesh
     at each stage's first step, coarse.pt and medium.pt at the boundaries
     and latest.pt at the end, the fine epoch's debug dump; exactly 37
     splat forward, 36 backward and 1 mesh launches; prints per stage the
     median s/step, the remesh and the converged rays, and the frame-load
     seconds of epoch 0 (cold decode) against epoch 1 (the dataset's
     cache);
  3f. the A/B tools through their entry points, one variant per call:
     ``tools.ab_stage_resume`` from 3e's coarse.pt into one medium epoch
     with 4 eval frames (base: 12 + 12 splat and 4 mesh launches;
     ref_exact: 12 more mesh launches, the fragment seeds) and
     ``tools.ab_convergence`` for 6 coarse steps on phase 3's subject and
     IGR cache (base and cauchy: 18 + 18 splat and 8 mesh launches); every
     maskE and ray_frac finite and in [0, 1], and a Cauchy variant must
     converge a ray in some step; prints both tools' tables;
  3g. data parallel: phase 3's subject and caches copied, one coarse
     epoch (4 steps) through the train CLI without --mesh (the plain
     path) and with --mesh dp=1 (one spawned rank over NCCL; its
     launches, history and step seconds come back through the tune hook
     ``StepRecorder``), each with torch's default algorithms and with its
     deterministic ones: exactly 12 + 12 splat and 0 mesh launches each;
     with the deterministic algorithms every info value of every step of
     dp=1 must be the plain run's bit for bit (with the default ones the
     colour and normal losses' per-frame index_add sums differ in their
     last bits from run to run: the script prints which values differ and
     by how much); prints s/step, the process group's set-up seconds and
     the bytes one step all-reduces; with a second card, dp=2 against
     dp=1;
  4. inference path: ``selfreconcode_tpu_torch.cli.infer.main`` with
     --synthetic-body on phase 3's checkpoint, 2 frames (template remesh,
     Phong and def1 renders, maskE against the body's own silhouettes,
     colour solve); errors.txt must parse with 2 evaluated frames, each
     maskE finite and in [0, 1];
  4b. texture: ``template/uvmap.obj`` written from phase 3b's fine template
     with a cylindrical UV (faces_vt = faces_v), then
     ``selfreconcode_tpu_torch.cli.texture`` prepare --num 4 (the fine
     checkpoint through load_checkpoint, the uvmap deformed on the card)
     and extract --tex-size 1024: exactly one mesh-kernel launch per baked
     frame; prints prepare_s, bake_s_per_frame, coverage and the size.
     Then the bake on the card is held to the CPU, each half on the same
     inputs: frame 0's view weights from the card's fragments (within
     4e-6) and the aggregation of all 4 frames from the card's fragments
     and weights (texture and weight within 1e-6).
     Every path (the subject renders, coarse, fine, fragment steps, the
     resumes, the schedule, each A/B variant, inference, the texture CLIs,
     the acceptance flow and each timing tool) runs with all launch
     counters zeroed right before it and read right after, and must launch each
     kernel it uses (splat forward and backward in training, the mesh
     kernel in the renders, the debug dump, fragment seeding, inference and
     the bake); the kernels line sums them;
  3h. acceptance at 1080x1080 (run after 4b): ``tools.acceptance_run`` on a
     12-frame subject with phase 3's IGR and skinner caches and 3e's stage
     epochs, --epochs 2 (4 coarse, 6 medium and 12 fine steps), inference of
     4 frames; exactly 37 + 36 splat and 12 + 1 + 8 mesh launches (render,
     debug dump, inference); prints its JSON line (per-stage median s/step
     and epoch seconds, the projection onto config.conf's 201 epochs at 450
     frames from this run's step counts, maskE, and Chamfer and normal
     consistency of rec/tmp.ply against the ground truth posed into the
     canonical pose); Chamfer finite, normal consistency and maskE in
     [0, 1]; then ``tools.host_mask_eval`` on the 4 frames (no kernel
     launch): the exact silhouettes, the training masks' hole and excess
     fractions against them (an independent check of the mesh kernel's
     masks), maskE against both;
  3i. timing: ``tools.profile_step`` at 1080x1080 on the synthetic trainer,
     coarse N=3 and fine N=1, 3 calls (wall, CUDA-event span and
     profiler-busy ms per pass, their sum, the steady train_step);
     ``tools.bench_outer`` and ``tools.bench_remesh`` on the fine stage;
     ``tools.bench_infer`` on 3h's checkpoint, 2 frames (exactly 4 mesh
     launches); ``tools.parity_sweep --stage fine --igr-iters 300`` (sign
     mismatches 0 at 321x417x225); ``bench_throughput`` at 512x512, fine,
     6144 rays, 6 steps (steps/s, not a benchmark cell);
  5. splat kernels vs plain on the card at shape A (1080x1080 frame, 134k
     points on a body-sized shell, radius 0.0041), shape B (the trained
     template deformed into frame 0 of the 512x512 scene, radius 0.006),
     shape E (phase 3b's fine-stage template deformed into frame 0 of the
     1080x1080 subject, radius 0.0041: what the fine stage feeds them) and
     shape R (50k splats each at distance r from a pixel centre, where the
     backward's coefficient jumps: the kernels must round w as the plain
     version does), and the dense-cell forms at shape B's bins laid out
     densely.  Each kernel runs twice and must give the same bits; the
     forward's two launches (the chunks, then the merge of cells that
     cross a chunk edge) are also timed apart (``fwd_chunks_us``,
     ``fwd_merge_us``: torch.profiler's kernel time of 20 calls);
  6. mesh kernel vs plain on the card at shape C (phase 4's template, the
     remesh of the trained SDF, deformed into frame 0 at 512x512 as the
     geometry pass deforms it), shape C-dup (C's faces twice over: every
     hit is an exact depth tie, which the first copy must win), shape D
     (C at 1080x1080, focal and principal point scaled by 1080/512), shape
     F (phase 3b's fine-stage template deformed into frame 0 at 1080x1080,
     binned with the stage's raster footprint: what fragment seeding and
     the debug dump rasterize), shape S (frame 0 of phase 3b's subject: the
     subdivided render mesh at the subject's own footprint, 16-24 px cells)
     and shape T (the texture bake's frame-0 mesh, the deformed uvmap, at
     the bake's footprint: the largest cells, 32 px).
     Each launch runs twice and must give the same bits;
  7. the kernels' JSON line, then the device JSON line last.

Each kernel is timed four ways at each shape: ``device_us``, its own time
on the card with its inputs in L2 (CUDA events around 100 back-to-back
launches of the raw ctypes entry point with the arguments prepared once,
behind a sleep kernel that keeps the stream busy); ``device_cold_us``, the
same launch alone after a read of 128 MB has emptied L2 of its inputs;
``wrapper_ms``, one call of the wrapper the main path calls, on an idle
stream (host checks, allocations, the ctypes call and the kernel: what the
main path pays per call); ``plain_ms``, the plain PyTorch version.
``bound_us`` is the least time the card could take for the timed launch:
the larger of the operations these inputs need at the float32 peak and the
bytes the launch must move at the HBM rate (``bound_by`` says which; the
zero fills torch makes before a launch are not counted).  ``library_ms`` is
null: no single PyTorch call computes a binned splat sum or a z-buffered
triangle raster.

Imports nothing of JAX.  Exits nonzero when any phase fails or no CUDA card
is present; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import os.path as osp
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = osp.dirname(osp.abspath(__file__))
FWD_TOL = 1e-4          # accumulator: |err| <= FWD_TOL * max(1, |acc|).  A
                        # pixel sums up to ~1000 float32 log1p terms of size
                        # <= 11.5 in another order than the plain version
                        # (index_add_); at |acc| ~ 250 one ulp is 1.5e-5, so
                        # a pure absolute 1e-4 is out of reach there.
MASK_TOL = 1e-6         # mask 1 - exp(acc), absolute
BWD_TOL = 1e-4          # per-point gradient, relative to max|g|
PEAK_F32 = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s (NVIDIA data sheet, 700 W)
# operations per unit of work, for the bounds
OPS_PAIR = 5            # a (splat, pixel) test: dc, dr, dc^2 + dr^2, w
OPS_LOG1P = 20          # forward, per pair with w > 0: clip, log1p, add
OPS_BWD_HIT = 9         # backward, per pair with 0 < w < 1 - 1e-5: 1 - w,
                        # reciprocal, three multiplies, two FMAs
OPS_EXP = 20            # forward, per active-cell pixel: 1 - exp(acc)
OPS_COT = 2             # backward, per active-cell pixel: -g * (1 - mask)
OPS_MESH_PAIR = 40      # mesh kernel, per (face entry, pixel of the face's
                        # box in its cell) pair, as the plain version
                        # computes it: four edge functions, three divides,
                        # the inside test, the depth and its compare
OPS_MESH_HIT = 40       # mesh kernel, per hit pixel: the winner's edge
                        # functions and divides again, three more divides
                        # to b_i / z_i, their sum and three to normalize
WEIGHT_TOL = 4e-6       # bake weight |n.v|^8, card vs CPU, absolute: d/dx
                        # x^8 is 8 at 1, so 4 float32 ulps of n.v (the
                        # normals summed in another order) move it ~2e-6
# mesh kernel vs plain: the kernel is built with -fmad=false and rounds like
# the plain version, and both keep the first minimum in run order, so every
# output must be identical: hit mask, z, face id and barycentrics


START = time.perf_counter()


def phase(n, msg):
    """The phase's banner, with the seconds since the script started."""
    print(f"[phase {n}] {msg} (t = {time.perf_counter() - START:.1f} s)",
          flush=True)


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


def rim_points(n, r_pix, size, seed):
    """(n, 3) screen points (col, row, z = 1) each at distance r_pix from a
    random pixel centre of a size x size image: every one has a pair with
    w ~ 0, where the backward's coefficient jumps, so a kernel that rounds w
    otherwise than the plain version disagrees with it there."""
    import numpy as np
    rng = np.random.default_rng(seed)
    c = rng.integers(8, size - 8, (n, 2))
    th = rng.uniform(0.0, 2.0 * np.pi, n)
    return np.stack([c[:, 0] + r_pix * np.cos(th), c[:, 1] + r_pix * np.sin(th),
                     np.ones(n)], 1).astype(np.float32)


def wrapper_ms(fn, runs=25, warmup=3):
    """Median ms of one call of fn on an idle stream, CUDA events around
    it: the host work of a wrapper (checks, allocations, the ctypes call)
    plus its kernel, what the main path pays per call."""
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


def device_us(call, n=100, reps=3):
    """The kernel's own device time in us with its inputs in L2: CUDA events
    around n back-to-back launches of the raw ctypes entry point, with its
    arguments prepared once (call = (function, arguments, output)), divided
    by n; the median of reps such runs.  A sleep kernel queued first keeps
    the stream busy while the host enqueues the launches, so no host time
    falls between them.  The inputs (at most ~20 MB here) stay in the 50 MB
    L2 from launch to launch; ``device_cold_us`` times the same launch from
    HBM."""
    import torch
    fn, args = call[:2]      # call[2] keeps the launch's buffers alive
    check_err(fn(*args))
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        errs = [fn(*args) for _ in range(n)]
        b.record()
        torch.cuda.synchronize()
        check_err(max(errs))
        times.append(a.elapsed_time(b) * 1e3 / n)
    return statistics.median(times)


def device_cold_us(call, n=50):
    """The kernel's own device time in us with a cold L2: before each of n
    launches a 128 MB buffer (over twice the H100's 50 MB L2) is read, so
    the launch finds none of its inputs in L2 and no dirty line to write
    back; CUDA events around each launch alone; the median.  Behind a sleep
    kernel, as in ``device_us``."""
    import torch
    fn, args = call[:2]
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    total = torch.empty((), device="cuda")
    check_err(fn(*args))
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(20_000_000)
    errs = []
    for a, b in ev:
        torch.sum(flush, dim=0, out=total)
        a.record()
        errs.append(fn(*args))
        b.record()
    torch.cuda.synchronize()
    check_err(max(errs))
    return statistics.median(a.elapsed_time(b) * 1e3 for a, b in ev)


def kernels_us(call, n=20):
    """Device us per call of each kernel that one raw call launches (the
    forward's chunk and merge kernels apart): the self device time of
    torch.profiler's CUDA kernel events over n calls, by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn, args = call[:2]
    check_err(fn(*args))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        errs = [fn(*args) for _ in range(n)]
        torch.cuda.synchronize()
    check_err(max(errs))
    return {e.key: e.self_device_time_total / n for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def check_err(err):
    if err != 0:
        raise RuntimeError(f"raw launch returned cudaError_t {err}")


def bound_us(ops, nbytes):
    """(least time in us, what bounds it): the larger of ops at the float32
    peak and bytes at the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e6, nbytes / PEAK_BYTES * 1e6
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cell_pixels(cell_ids, cs, ncx, H, W):
    """Pixels of the (H, W) image inside these cells."""
    import torch
    c = cell_ids.long()
    w = (W - c % ncx * cs).clamp(0, cs)
    h = (H - c // ncx * cs).clamp(0, cs)
    return int((w * h).sum()) if c.numel() else 0


def splat_work(col, row, entries, cell_ids, counts, cs, ncx, r2_inv, H, W):
    """What these splat inputs need: the distinct points the entries name,
    the active cells' pixels in the image, the (entry, cell pixel) pairs,
    the pairs inside each splat's square bbox (what an exact kernel must
    test), the in-radius pairs of the forward (w > 0) and of the backward
    (0 < w < 1 - 1e-5)."""
    import torch
    from selfreconcode_tpu_torch.ops.splat_kernels import decode
    P = cs * cs
    p = decode(entries, col.shape[0])
    cell = torch.repeat_interleave(cell_ids.long(), counts.long())
    k = torch.arange(P, device=col.device)
    dc = col[p][:, None] - ((cell % ncx * cs)[:, None] + k % cs).float()
    dr = row[p][:, None] - ((cell // ncx * cs)[:, None] + k // cs).float()
    w = 1.0 - (dc * dc + dr * dr) * r2_inv
    r = r2_inv ** -0.5
    return {"points": int(torch.unique(p).numel()),
            "cell_px": cell_pixels(cell_ids[counts > 0], cs, ncx, H, W),
            "cell_pairs": int(p.numel()) * P,
            "bbox_pairs": int(((dc.abs() <= r) & (dr.abs() <= r)).sum()),
            "fwd_hits": int((w > 0).sum()),
            "bwd_hits": int(((w > 0) & (w < 1.0 - 1e-5)).sum())}


def splat_bounds(work, M, n_cells, fused):
    """Bounds of the timed forward and backward launches at one shape, from
    what they must touch.  The zero fills of the output image and of the
    slot gradients are torch's, before the launch, and count for neither.
    Forward: reads the distinct points, the M valid entries and their cells
    and the n_cells cells' run starts and lengths, and writes the active
    cells' pixels (with
    1 - exp(acc) on each when fused).  Backward: reads the points, entries
    and entry cells, and on the active cells' pixels the mask's gradient
    and the mask (fused: it forms -g (1 - mask) there) or the cotangent,
    and writes M gradient pairs."""
    px = work["cell_px"]
    ins = 8 * work["points"] + 8 * M
    fwd = bound_us(OPS_PAIR * work["bbox_pairs"]
                   + OPS_LOG1P * work["fwd_hits"] + fused * OPS_EXP * px,
                   ins + 8 * n_cells + 4 * px)
    bwd = bound_us(OPS_PAIR * work["bbox_pairs"]
                   + OPS_BWD_HIT * work["bwd_hits"] + fused * OPS_COT * px,
                   ins + (8 if fused else 4) * px + 8 * M)
    return fwd, bwd


def compare_kernels(label, cam, pts, radius, seed, screen=None):
    """Kernel vs plain on the card at one shape (the world points pts seen
    by cam, or the given screen points); returns a result dict."""
    import torch
    from selfreconcode_tpu_torch.ops import splat_kernels as SK
    from selfreconcode_tpu_torch.ops.rasterize import (splat_bins,
                                                       splat_cell_size)
    from selfreconcode_tpu_torch.render.camera import transform_points_screen

    H, W = cam.H, cam.W
    r_pix = radius * W / 2.0
    with torch.no_grad():
        s = transform_points_screen(cam, pts) if screen is None else screen
        col, row = s[:, 0].contiguous(), s[:, 1].contiguous()
        valid = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
        b = splat_bins(col, row, s[:, 2], valid, r_pix, H, W,
                       splat_cell_size(r_pix, 9))
        r2_inv = 1.0 / float(r_pix * r_pix)
        n = col.shape[0]
        fargs = (col, row, b.entries, b.ecell, b.count, b.starts, b.counts,
                 b.cs, b.ncx, H, W, r2_inv)
        gen = torch.Generator(device=s.device).manual_seed(seed)
        g_img = torch.randn((H, W), generator=gen, device=s.device)

        mask_k = SK.splat_fwd(*fargs)
        mask_p = SK.splat_fwd_plain(*fargs)
        acc_k = SK.splat_fwd(*fargs, to_mask=False)
        acc_p = SK.splat_fwd_plain(*fargs, to_mask=False)
        bargs = (col, row, b.entries, b.ecell, b.count, g_img, mask_k, b.cs,
                 b.ncx, r2_inv, 4 * n)
        g_k = SK.splat_bwd(*bargs)
        g_p = SK.splat_bwd_plain(*bargs)
        same = (torch.equal(mask_k, SK.splat_fwd(*fargs)),
                torch.equal(g_k, SK.splat_bwd(*bargs)))
        torch.cuda.synchronize()

        fwd_err = float(((acc_k - acc_p).abs()
                         / acc_p.abs().clamp_min(1.0)).max())
        mask_err = float((mask_k - mask_p).abs().max())
        gk, gp = (g.reshape(4, n, 2).sum(0) for g in (g_k, g_p))
        gmax = float(gp.abs().max())
        bwd_err = float((gk - gp).abs().max())
        m = int(b.count)
        cells = torch.arange(b.counts.numel(), device=s.device)
        work = splat_work(col, row, b.entries[:m], cells, b.counts, b.cs,
                          b.ncx, r2_inv, H, W)
        (fb, fby), (bb, bby) = splat_bounds(work, m, cells.numel(),
                                            fused=True)
        fcall, bcall = SK.fwd_call(*fargs), SK.bwd_call(*bargs)
        split = kernels_us(fcall)
        out = {
            "shape": label, "n_pts": int(s.shape[0]), "entries": m,
            "slots": int(b.entries.numel()),
            "active_cells": int((b.counts > 0).sum()),
            "max_occupancy": int(b.counts.max()), **work,
            "fwd_max_err": fwd_err, "mask_max_abs_err": mask_err,
            "bwd_max_abs_err": bwd_err,
            "bwd_max_abs_g": gmax, "bit_identical": same,
            "fwd_device_us": device_us(fcall),
            "fwd_device_cold_us": device_cold_us(fcall),
            "fwd_chunks_us": sum(v for k, v in split.items()
                                 if "merge" not in k),
            "fwd_merge_us": sum(v for k, v in split.items() if "merge" in k),
            "fwd_wrapper_ms": wrapper_ms(lambda: SK.fwd(*fargs)),
            "fwd_plain_ms": wrapper_ms(lambda: SK.splat_fwd_plain(*fargs)),
            "fwd_bound_us": fb, "fwd_bound_by": fby,
            "bwd_device_us": device_us(bcall),
            "bwd_device_cold_us": device_cold_us(bcall),
            "bwd_wrapper_ms": wrapper_ms(lambda: SK.bwd(*bargs)),
            "bwd_plain_ms": wrapper_ms(lambda: SK.splat_bwd_plain(*bargs)),
            "bwd_bound_us": bb, "bwd_bound_by": bby,
        }
    print(f"  {label}: {json.dumps(out)}", flush=True)
    if not (fwd_err <= FWD_TOL and mask_err <= MASK_TOL):
        raise AssertionError(f"{label}: forward kernel disagrees with the "
                             f"plain version: acc {fwd_err} > {FWD_TOL} "
                             f"or mask {mask_err} > {MASK_TOL}")
    if not bwd_err <= BWD_TOL * gmax:
        raise AssertionError(f"{label}: backward kernel disagrees with the "
                             f"plain version: {bwd_err} > {BWD_TOL} * {gmax}")
    if not all(same):
        raise AssertionError(f"{label}: two launches differ (fwd, bwd "
                             f"identical: {same})")
    return out


def compare_dense(label, cam, pts, radius, seed):
    """The dense-cell splat forms vs their plain versions at one shape's
    bins laid out densely: every cell a row of cap slots, empty slots at
    BIG."""
    import torch
    from selfreconcode_tpu_torch.ops import splat_kernels as SK
    from selfreconcode_tpu_torch.ops.rasterize import (splat_bins,
                                                       splat_cell_size)
    from selfreconcode_tpu_torch.render.camera import transform_points_screen

    H, W = cam.H, cam.W
    r_pix = radius * W / 2.0
    with torch.no_grad():
        s = transform_points_screen(cam, pts)
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
        b = splat_bins(s[:, 0], s[:, 1], s[:, 2], valid, r_pix, H, W,
                       splat_cell_size(r_pix, 9))
        C = b.counts.numel()
        cap = -(-int(b.counts.max()) // 64) * 64
        counts = b.counts.long()
        m = int(b.count)
        cell = torch.repeat_interleave(
            torch.arange(C, device=pts.device), counts)
        slot = (torch.arange(m, device=pts.device)
                - torch.repeat_interleave(b.starts.long(), counts))
        p = b.entries[:m].long() % pts.shape[0]
        dense = torch.full((C, 2, cap), SK.BIG, device=pts.device)
        dense[cell, 0, slot] = s[p, 0]
        dense[cell, 1, slot] = s[p, 1]
        gen = torch.Generator(device=pts.device).manual_seed(seed)
        cot = torch.randn((C, b.cs * b.cs), generator=gen, device=pts.device)
        args = (b.cs, b.ncx, r_pix)
        r2_inv = 1.0 / float(r_pix * r_pix)
        bins, hp, wp = SK.dense_bins(dense, b.cs, b.ncx)
        cot_img = SK.cells_to_image(cot, b.cs, b.ncx)
        acc_k = SK.splat_fwd_cells(dense, *args)
        acc_p = SK.splat_fwd_cells_plain(dense, *args)
        g_k = SK.splat_bwd_cells(dense, cot, *args)
        g_p = SK.splat_bwd_cells_plain(dense, cot, *args)
        torch.cuda.synchronize()
        fwd_err = float(((acc_k - acc_p).abs()
                         / acc_p.abs().clamp_min(1.0)).max())
        fwd_abs = float((acc_k - acc_p).abs().max())
        gmax = float(g_p.abs().max())
        bwd_err = float((g_k - g_p).abs().max())
        same = (torch.equal(acc_k, SK.splat_fwd_cells(dense, *args)),
                torch.equal(g_k, SK.splat_bwd_cells(dense, cot, *args)))
        # the timed launches read the compacted bins, never the dense slots
        col_d, row_d, ent_d, _, _, _, counts_d = bins
        work = splat_work(col_d, row_d, ent_d,
                          torch.arange(C, device=pts.device), counts_d, b.cs,
                          b.ncx, r2_inv, hp, wp)
        (fb, fby), (bb, bby) = splat_bounds(work, ent_d.numel(), C,
                                            fused=False)
        fcall = SK.fwd_call(*bins, b.cs, b.ncx, hp, wp, r2_inv, to_mask=False)
        bcall = SK.bwd_call(*bins[:5], cot_img, None, b.cs, b.ncx, r2_inv,
                            C * cap)
        out = {
            "shape": label, "cells": C, "cap": cap, "filled_slots": m, **work,
            "fwd_max_err": fwd_err, "fwd_max_abs_err": fwd_abs,
            "bwd_max_abs_err": bwd_err, "bwd_max_abs_g": gmax,
            "bit_identical": same,
            "fwd_device_us": device_us(fcall),
            "fwd_device_cold_us": device_cold_us(fcall),
            "fwd_wrapper_ms": wrapper_ms(
                lambda: SK.splat_fwd_cells(dense, *args)),
            "fwd_plain_ms": wrapper_ms(
                lambda: SK.splat_fwd_cells_plain(dense, *args)),
            "fwd_bound_us": fb, "fwd_bound_by": fby,
            "bwd_device_us": device_us(bcall),
            "bwd_device_cold_us": device_cold_us(bcall),
            "bwd_wrapper_ms": wrapper_ms(
                lambda: SK.splat_bwd_cells(dense, cot, *args)),
            "bwd_plain_ms": wrapper_ms(
                lambda: SK.splat_bwd_cells_plain(dense, cot, *args)),
            "bwd_bound_us": bb, "bwd_bound_by": bby,
        }
    print(f"  {label}: {json.dumps(out)}", flush=True)
    if not fwd_err <= FWD_TOL:
        raise AssertionError(f"{label}: dense forward disagrees with the "
                             f"plain version: {fwd_err} > {FWD_TOL}")
    if not bwd_err <= BWD_TOL * gmax:
        raise AssertionError(f"{label}: dense backward disagrees with the "
                             f"plain version: {bwd_err} > {BWD_TOL} * {gmax}")
    if not all(same):
        raise AssertionError(f"{label}: two launches differ (fwd, bwd "
                             f"identical: {same})")
    return out


def timings(res, prefix=""):
    """One shape's numbers for the kernels line."""
    return {key: res[prefix + key] for key in
            ("device_us", "device_cold_us", "wrapper_ms", "plain_ms",
             "bound_us", "bound_by")}


def kernel_row(name, source, line, launches, max_abs_err, shapes, head,
               note=None):
    """A kernel's entry in the kernels line: the contract's keys at the
    shape the main path meets most (head), and every shape's numbers.  ms
    is the kernel's own device time with its inputs in L2 (device_cold_us:
    from HBM); wrapper_ms adds the wrapper's host work on an idle
    stream."""
    h = shapes[head]
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": f"selfreconcode_tpu/ops/pallas_raster.py:{line}",
           "launches": launches, "max_abs_err": max_abs_err,
           "ms": h["device_us"] / 1e3, "plain_ms": h["plain_ms"],
           "bound_ms": h["bound_us"] / 1e3, "bound_by": h["bound_by"],
           "library_ms": None, "device_us": h["device_us"],
           "device_cold_us": h["device_cold_us"],
           "wrapper_ms": h["wrapper_ms"], "bound_us": h["bound_us"],
           "at": head, "shapes": shapes}
    if note:
        row["note"] = note
    return row


def mesh_work(rec, entries, cell_ids, counts, cs, ncx, H, W, chunk=1 << 22):
    """What these mesh inputs need, over the (entry, pixel of its cell in
    the image) pairs in chunks: their count, the pairs inside the entry's
    pixel box (``pixel_box``: what an exact kernel must test), the pairs
    inside the triangle, and the entries of slivers whose box is unbounded
    (their whole cell is tested)."""
    import torch
    from selfreconcode_tpu_torch.ops import mesh_kernels as MK
    P = cs * cs
    F = rec.shape[0]
    k = torch.arange(P, device=rec.device)
    cell_all = torch.repeat_interleave(cell_ids.long(), counts.long())
    work = {"cell_pairs": 0, "box_pairs": 0, "inside_pairs": 0,
            "unbounded_entries": 0}
    for e0 in range(0, entries.numel(), max(chunk // P, 1)):
        e1 = min(e0 + max(chunk // P, 1), entries.numel())
        cell = cell_all[e0:e1]
        px = ((cell % ncx * cs)[:, None] + k % cs).float()
        py = ((cell // ncx * cs)[:, None] + k // cs).float()
        r = rec[entries[e0:e1].long() % F]
        x_lo, x_hi, y_lo, y_hi = (t[:, None] for t in MK.pixel_box(r))
        img = (px < W) & (py < H)
        box = img & (px >= x_lo) & (px <= x_hi) & (py >= y_lo) & (py <= y_hi)
        inside = MK.edge_bary(r[:, None, :], px, py)[3] & img
        work["cell_pairs"] += int(img.sum())
        work["box_pairs"] += int(box.sum())
        work["inside_pairs"] += int(inside.sum())
        work["unbounded_entries"] += int((x_lo[:, 0] == -math.inf).sum())
        if bool((inside & ~box).any()):
            raise AssertionError("a pixel inside a face lies outside its "
                                 "pixel box")
    return work


def compare_mesh(label, cam, verts, faces, first_faces=None, footprint=8):
    """The mesh kernel vs its plain version at one shape, binned with the
    footprint its caller passes (which picks the cell size).  first_faces =
    F for a mesh whose faces are F faces twice over: every hit must then
    name a face < F (the first in run order wins the exact depth tie)."""
    import torch
    from selfreconcode_tpu_torch.ops import mesh_kernels as MK
    from selfreconcode_tpu_torch.ops.rasterize import mesh_bins

    H, W = cam.H, cam.W
    with torch.no_grad():
        rec, b = mesh_bins(cam, verts, faces, footprint)
        args = (rec, b.entries, b.cell_ids, b.starts, b.counts, b.cs, b.ncx,
                H, W)
        zk, fk, bk = MK.mesh_fragments(*args)
        zp, fp, bp = MK.mesh_fragments_plain(*args)
        same = all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                   for u, v in zip((zk, fk, bk), MK.mesh_fragments(*args)))
        torch.cuda.synchronize()
        hk, hp = fk >= 0, fp >= 0
        both = hk & hp
        dz = (zk - zp).abs()
        diff = both & (fk != fp)
        bary_err = float((bk - bp).abs()[both].max())
        # the largest on-screen bbox side of a binned face
        r = rec[torch.unique(b.entries.long() % rec.shape[0])]
        xs, ys = r[:, 0:6:2], r[:, 1:6:2]
        ext = torch.maximum(xs.amax(1) - xs.amin(1), ys.amax(1) - ys.amin(1))
        M, A = b.entries.numel(), b.cell_ids.numel()
        work = mesh_work(rec, b.entries, b.cell_ids, b.counts, b.cs, b.ncx,
                         H, W)
        # operations: each (entry, pixel of its box in the cell) pair is
        # tested, each hit pixel's barycentrics recomputed.  Bytes: the
        # launch reads the binned faces' records, the entries and the
        # per-cell arrays and writes z, face and bary on the active cells'
        # pixels (torch fills the rest before it)
        hits = int(hp.sum())
        bnd, bnd_by = bound_us(
            OPS_MESH_PAIR * work["box_pairs"] + OPS_MESH_HIT * hits,
            36 * r.shape[0] + 4 * M + 12 * A
            + 20 * cell_pixels(b.cell_ids, b.cs, b.ncx, H, W))
        call = MK.raster_call(*args)
        out = {
            "shape": label, "faces": int(faces.shape[0]),
            "footprint": int(footprint), "cell_px": b.cs,
            "max_face_px": float(ext.max()),
            "entries": M, "active_cells": A,
            "max_occupancy": int(b.counts.max()),
            "hit_pixels": hits,
            "hit_mismatch": int((hk != hp).sum()),
            "z_max_abs_err": float(dz[both].max()),
            "face_disagree": int(diff.sum()), "bary_max_abs_err": bary_err,
            "bit_identical": same, **work,
            "device_us": device_us(call),
            "device_cold_us": device_cold_us(call),
            "wrapper_ms": wrapper_ms(lambda: MK.mesh_fragments(*args)),
            "plain_ms": wrapper_ms(lambda: MK.mesh_fragments_plain(*args)),
            "bound_us": bnd, "bound_by": bnd_by,
        }
        if first_faces is not None:
            out["max_hit_face"] = int(fk[hk].max())
    print(f"  {label}: {json.dumps(out)}", flush=True)
    if (out["hit_mismatch"] or out["face_disagree"] or out["z_max_abs_err"]
            or bary_err):
        raise AssertionError(f"{label}: mesh kernel and plain version are "
                             f"not identical: {out}")
    if not out["hit_pixels"]:
        raise AssertionError(f"{label}: nothing rasterized")
    if not same:
        raise AssertionError(f"{label}: two launches differ")
    if first_faces is not None and out["max_hit_face"] >= first_faces:
        raise AssertionError(f"{label}: face {out['max_hit_face']} won an "
                             f"exact tie against its first copy")
    return out


def counted(fn, *args, **kw):
    """fn(*args, **kw) with every kernel's launch counter zeroed right
    before and read right after; returns (result, {kernel: launches}).
    Prints the seconds the call took."""
    import torch
    launch_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    print(f"  {getattr(fn, '__module__', '')}.{fn.__name__} took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out, launch_counts()


KERNELS = ("mesh_raster", "splat_fwd_cells", "splat_fwd", "splat_bwd",
           "splat_bwd_cells")


def launch_counts():
    """{kernel: launches} counted since the last read, from the port's
    trace registry (``utils/trace.py``), which the read clears."""
    from selfreconcode_tpu_torch.utils import trace
    c = trace.read_and_clear()["counters"]
    return {k: c.get(f"{k}_launches", 0) for k in KERNELS}


def need_launches(path, launched, **least):
    """Fail unless each named kernel launched at least so often."""
    print(f"  launches on the {path} path: {launched}", flush=True)
    short = {k: (launched[k], n) for k, n in least.items() if launched[k] < n}
    if short:
        raise AssertionError(f"{path}: kernels launched fewer times than "
                             f"the path needs, (launched, needed): {short}")


def body_pickle(workdir):
    """The default synthetic body in the SMPL asset schema, where get_smpl
    finds it ($SMPL_MODEL_DIR)."""
    from selfreconcode_tpu_torch.models.synthetic_body import (
        save_smpl_pickle, synthetic_body_model)
    assets = osp.join(workdir, "assets")
    os.makedirs(assets)
    save_smpl_pickle(synthetic_body_model(),
                     osp.join(assets, "neutral_smpl_with_cocoplus_reg.pkl"))
    os.environ["SMPL_MODEL_DIR"] = assets


def subject(root, n_frames, size, paths):
    """Render the subject on the card; records the path's launches."""
    from selfreconcode_tpu_torch.data.synthetic_subject import \
        make_synthetic_subject
    t0 = time.perf_counter()
    _, launched = counted(make_synthetic_subject, root, n_frames=n_frames,
                          H=size, W=size, verbose=False, device="cuda")
    dt = time.perf_counter() - t0
    print(f"  subject {size}x{size}: {n_frames} frames in {dt:.3f} s "
          f"({dt / n_frames:.4f} s/frame, PNG writes included)", flush=True)
    need_launches(f"subject {size}", launched, mesh_raster=n_frames)
    paths[f"subject {size}"] = launched


def check_steps(hist, P, n_steps, what):
    losses = [h["loss"] for h in hist]
    print(f"  {what}: steps {len(hist)}; losses {losses}", flush=True)
    print(f"  inv_ok {[int(h['inv_ok']) for h in hist]} of P={P}; "
          f"ray_converged {[int(h['ray_converged']) for h in hist]}",
          flush=True)
    if len(hist) != n_steps:
        raise AssertionError(f"{what}: expected {n_steps} steps, ran "
                             f"{len(hist)}")
    bad = [h for h in hist if not all(math.isfinite(v) for v in h.values())]
    if bad:
        raise AssertionError(f"{what}: non-finite info {bad[0]}")
    if any(int(h["inv_ok"]) != P for h in hist):
        raise AssertionError(f"{what}: inv_ok != P on some step")


def print_seconds(trainer, what, wall):
    times = trainer.timings
    print(f"  {what} seconds: skinner build {times['skinner']:.3f}, IGR "
          f"{times['igr']:.3f}, last remesh {times['remesh']:.3f}, mean "
          f"step {statistics.mean(times['steps']):.3f} (steps "
          f"{[round(t, 3) for t in times['steps']]}), whole run {wall:.1f}",
          flush=True)


def main_path(workdir, paths):
    """Phase 3: render the subject, drive the train CLI with no body flag
    (the pickle through get_smpl); returns the trainer."""
    import torch
    from selfreconcode_tpu_torch.cli import train as cli

    body_pickle(workdir)
    scene = osp.join(workdir, "scene")
    subject(scene, 12, 512, paths)
    argv = ["--conf", osp.join(ROOT, "configs", "config.conf"),
            "--data", scene, "--save-folder", "rec", "--max-epochs", "0",
            "--device", "cuda"]
    t0 = time.perf_counter()
    trainer, launched = counted(cli.main, argv)
    wall = time.perf_counter() - t0
    hist = trainer.history
    print(f"  body {trainer.body_vs.shape[0]} vertices through "
          f"$SMPL_MODEL_DIR; template {trainer.tmp.verts.shape[0]} verts, "
          f"{trainer.tmp.faces.shape[0]} faces", flush=True)
    check_steps(hist, trainer.rays_per_step(), 4, "coarse")
    print(f"  def_loss at step 0: {hist[0].get('def_loss')}; normal_loss "
          f"{[h.get('normal_loss') for h in hist]}", flush=True)
    print_seconds(trainer, "coarse", wall)
    if trainer.body_vs.shape[0] != 6890:
        raise AssertionError("the body did not come from the pickle")
    if abs(hist[0]["def_loss"]) > 1e-4:
        raise AssertionError(f"def_loss at step 0 is {hist[0]['def_loss']}")
    if not all("normal_loss" in h for h in hist):
        raise AssertionError("no normal loss: the subject's normal maps "
                             "were not read")
    need_launches("coarse", launched, splat_fwd=12, splat_bwd=12)
    paths["coarse"] = launched
    if not osp.isfile(osp.join(scene, "rec", "latest.pt")):
        raise AssertionError("no checkpoint")
    return trainer


def reference_pth(trainer, path, epoch):
    """Write the trainer as a reference-format checkpoint (the reference's
    utils/utils.py:257-264): the nets' state_dict under the reference key
    names, two keys the loader must drop (``engine.*``, the skinner's
    ``deformer.defs.1.*``), and the bank at the top level with the focal
    length moved +1% (a camera the scene's camera.npz does not hold).
    Returns the file's camera."""
    import torch
    from selfreconcode_tpu_torch.engine.torch_compat import CAM_KEYS
    sd = {k: v.detach().cpu() for k, v in trainer.nets.state_dict().items()}
    sd["engine.b_min"] = torch.zeros(1, 3)
    sd["deformer.defs.1.ws"] = torch.zeros(2, 2, 2, 2, 2)
    bank = {k: v.detach().cpu().clone() for k, v in trainer.bank.items()}
    bank["focal_length"] *= 1.01
    torch.save({"epoch": epoch, "model_state_dict": sd, **bank}, path)
    return {k: bank[k].numpy() for k in CAM_KEYS}


def interchange_path(workdir, trainer, paths):
    """Phase 3d: resume phase 3's subject through the checkpoint
    interchange with the train CLI: (a) one coarse epoch from a reference
    .pth of phase 3's trainer; (b) phase 3's latest.pt with --sdf-model a
    bare SDF state_dict .pth (the IGR cache)."""
    import numpy as np
    import torch
    from selfreconcode_tpu_torch.cli import train as cli
    from selfreconcode_tpu_torch.engine.torch_compat import CAM_KEYS

    scene = osp.join(workdir, "scene")
    argv = ["--conf", osp.join(ROOT, "configs", "config.conf"), "--data",
            scene, "--max-epochs", "1", "--device", "cuda"]
    pth = osp.join(workdir, "reference.pth")
    cam = reference_pth(trainer, pth, epoch=1)
    t0 = time.perf_counter()
    tr, launched = counted(cli.main, argv + ["--save-folder", "rec_pth",
                                             "--model", pth])
    wall = time.perf_counter() - t0
    check_steps(tr.history, tr.rays_per_step(), 4, "resumed from a .pth")
    print_seconds(tr, "resumed from a .pth", wall)
    got = tr.dataset.camera_params
    print(f"  dataset camera after the load: "
          f"{ {k: got[k].tolist() for k in CAM_KEYS} }", flush=True)
    if not all(np.array_equal(got[k], cam[k]) for k in CAM_KEYS):
        raise AssertionError(f"the dataset's camera {got} is not the "
                             f"file's {cam}: the bank was not written back")
    need_launches("resume from a .pth", launched, splat_fwd=12, splat_bwd=12)
    paths["resume .pth"] = launched

    bare = osp.join(workdir, "sdf_bare.pth")
    shutil.copyfile(osp.join(scene, "initial_sdf_idr_6_1_torch.pt"), bare)
    want = torch.load(bare, map_location="cpu")
    seen = {}

    def tune(t):
        if not seen:      # right after the load, before the first step
            sd = t.nets.sdf.state_dict()
            seen["sdf"] = set(sd) == set(want) and all(
                torch.equal(v.cpu(), want[k]) for k, v in sd.items())
            seen["adam"] = len(t.optimizer.state)

    t0 = time.perf_counter()
    tr, launched = counted(cli.main, argv + [
        "--save-folder", "rec_sdf", "--model",
        osp.join(scene, "rec", "latest.pt"), "--sdf-model", bare], tune=tune)
    wall = time.perf_counter() - t0
    check_steps(tr.history, tr.rays_per_step(), 4, "--sdf-model")
    print_seconds(tr, "--sdf-model", wall)
    print(f"  --sdf-model: SDF equal to the file's {seen['sdf']}, Adam "
          f"entries before the first step {seen['adam']}", flush=True)
    if not seen["sdf"] or seen["adam"]:
        raise AssertionError(f"--sdf-model: {seen}")
    need_launches("--sdf-model", launched, splat_fwd=12, splat_bwd=12)
    paths["resume --sdf-model"] = launched


def exact_launches(path, launched, **want):
    """Fail unless each named kernel launched exactly so often."""
    need_launches(path, launched, **want)
    off = {k: (launched[k], n) for k, n in want.items() if launched[k] != n}
    if off:
        raise AssertionError(f"{path}: kernels launched other than the path "
                             f"needs, (launched, needed): {off}")


def stage_conf(workdir, name, medium_at, fine_at):
    """configs/config.conf with the medium and fine stages starting at
    these epochs; every other key as it is."""
    conf = open(osp.join(ROOT, "configs", "config.conf")).read()
    for a, b in (("start_epoch = 6", f"start_epoch = {medium_at}"),
                 ("start_epoch = 12", f"start_epoch = {fine_at}")):
        if conf.count(a) != 1:
            raise AssertionError(f"config.conf has no single '{a}'")
        conf = conf.replace(a, b)
    path = osp.join(workdir, name)
    with open(path, "w") as f:
        f.write(conf)
    return path


SCHEDULE = (("coarse", 3, 4), ("medium", 2, 6), ("fine", 1, 12))


def time_loads(dataset, add):
    """Wrap dataset.batch_raw so that add(seconds) gets each call's time."""
    load = dataset.batch_raw

    def timed(fids):
        t0 = time.perf_counter()
        out = load(fids)
        add(time.perf_counter() - t0)
        return out

    dataset.batch_raw = timed


def schedule_path(workdir, paths):
    """Phase 3e: the three-stage schedule through the train CLI on a copy
    of phase 3's subject and caches, with a conf whose medium stage starts
    at epoch 1 and fine at epoch 2, for --max-epochs 2.  A tune hook marks
    each stage's start and times the dataset's frame loads and the remesh
    per stage.  Returns the run's root."""
    import torch
    from selfreconcode_tpu_torch.cli import train as cli
    from selfreconcode_tpu_torch.engine.torch_compat import load_torch

    root = osp.join(workdir, "schedule")
    shutil.copytree(osp.join(workdir, "scene"), root,
                    ignore=shutil.ignore_patterns("rec*"))
    conf = stage_conf(workdir, "schedule.conf", 1, 2)
    stages = []

    def tune(t):
        if not stages:
            remesh = t.remesh

            def timed_remesh(ratio):
                out = remesh(ratio)
                stages[-1]["remesh"].append((t.timings["remesh"], out[0]))
                return out

            time_loads(t.dataset, lambda s: stages[-1]["loads"].append(s))
            t.remesh = timed_remesh
        cfg = t.stage_cfg
        stages.append({"name": cfg.name, "N": cfg.N, "radius": cfg.radius,
                       "remesh_intersect": cfg.remesh_intersect,
                       "P": t.rays_per_step(), "first": len(t.history),
                       "loads": [], "remesh": []})

    t0 = time.perf_counter()
    tr, launched = counted(cli.main, [
        "--conf", conf, "--data", root, "--save-folder", "rec",
        "--max-epochs", "2", "--device", "cuda"], tune=tune)
    wall = time.perf_counter() - t0
    hist, steps = tr.history, tr.timings["steps"]
    seen = [(s["name"], s["N"], s["radius"], s["remesh_intersect"], s["P"])
            for s in stages]
    for s in stages:
        s["load_s"] = sum(s["loads"])
    print(f"  stages (name, N, radius, remesh_intersect, rays): {seen}; "
          f"whole run {wall:.1f} s", flush=True)
    if [(s["name"], s["N"]) for s in stages] != [(n, N) for n, N, _ in
                                                  SCHEDULE]:
        raise AssertionError(f"not coarse N=3 -> medium N=2 -> fine N=1: "
                             f"{stages}")
    if stages[1]["radius"] != 0.00465 or stages[1]["remesh_intersect"] != 60:
        raise AssertionError(f"medium stage settings: {stages[1]}")
    bounds = [s["first"] for s in stages] + [len(hist)]
    for s, (name, _, n), a, b in zip(stages, SCHEDULE, bounds, bounds[1:]):
        check_steps(hist[a:b], s["P"], n, name)
        rays = [int(h["ray_converged"]) for h in hist[a:b]]
        print(f"  {name}: median step {statistics.median(steps[a:b]):.3f} s "
              f"(steps {[round(x, 3) for x in steps[a:b]]}); remesh "
              f"{[(round(r, 3), nv) for r, nv in s['remesh']]} (s, "
              f"vertices); converged rays {rays} of {s['P']}; frame loads "
              f"{s['load_s']:.3f} s", flush=True)
        if len(s["remesh"]) != 1 or hist[a]["remesh"] != math.floor(
                hist[a]["remesh"]):
            raise AssertionError(f"{name}: not one remesh, at the stage's "
                                 f"first step: {s['remesh']}")
    print(f"  frame loads: epoch 0 {stages[0]['load_s']:.3f} s (cold: 12 "
          f"frames decoded), epoch 1 {stages[1]['load_s']:.3f} s (the "
          f"dataset's cache)", flush=True)
    if abs(hist[0]["def_loss"]) > 1e-4:
        raise AssertionError(f"def_loss at step 0 is {hist[0]['def_loss']}")
    rec = osp.join(root, "rec")
    for name, stage, epoch in (("coarse.pt", "coarse", 1),
                               ("medium.pt", "medium", 2),
                               ("latest.pt", "fine", 3)):
        z = load_torch(osp.join(rec, name))
        if (z["stage"], z["epoch"]) != (stage, epoch):
            raise AssertionError(f"{name}: stage {z['stage']} epoch "
                                 f"{z['epoch']}, not {stage} {epoch}")
    ckpts = sorted(f for f in os.listdir(rec) if f.endswith(".pt"))
    print(f"  checkpoints: {ckpts}; debug dump "
          f"{sorted(os.listdir(osp.join(rec, 'debug')))}", flush=True)
    # 12 frames a stage through the splat kernels, and the fine epoch's
    # debug dump: one splat mask and one mesh raster of its one frame
    exact_launches("schedule", launched, splat_fwd=37, splat_bwd=36,
                   mesh_raster=1)
    paths["schedule"] = launched
    del tr
    torch.cuda.empty_cache()
    return root


class StepRecorder:
    """The train CLI's tune hook for phase 3g; picklable, so a --mesh
    rank receives it.  With `deterministic` it switches torch to its
    deterministic algorithms before the steps, in whichever process runs
    them (the caller switches them off again).  On rank 0 it zeroes the
    launch counters before the first step and, after each step, writes the
    history, the step seconds, the process group's set-up seconds and the
    launch counts to `path` (a --mesh run's trainer lives in its spawned
    rank)."""

    def __init__(self, path, deterministic):
        self.path = path
        self.deterministic = deterministic

    def __call__(self, trainer):
        import torch
        from selfreconcode_tpu_torch import parallel as D
        if self.deterministic:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            torch.use_deterministic_algorithms(True, warn_only=True)
        if not D.is_main():
            return
        launch_counts()
        launched = dict.fromkeys(KERNELS, 0)
        step = trainer.train_step

        def recorded(*args, **kw):
            info = step(*args, **kw)
            torch.cuda.synchronize()
            for k, n in launch_counts().items():
                launched[k] += n
            with open(self.path, "w") as f:
                json.dump({"history": trainer.history,
                           "steps": trainer.timings["steps"],
                           "dp_setup": trainer.timings.get("dp_setup"),
                           "launches": launched}, f)
            return info

        trainer.train_step = recorded


def allreduce_bytes(trainer):
    """The float32 entries one data-parallel step all-reduces: every
    gradient of the nets and the bank, and each info value (the step
    function's first step adds a has-gradient flag per leaf and a presence
    flag per info value)."""
    from selfreconcode_tpu_torch.engine.trainer import STEP_INFO_KEYS
    nets = {name: sum(p.numel() for p in net.parameters()) for name, net in
            (("SDF", trainer.nets.sdf),
             ("translator", trainer.nets.translator),
             ("colour", trainer.nets.netRender))}
    bank = sum(v.numel() for v in trainer.bank.values())
    entries = sum(nets.values()) + bank + len(STEP_INFO_KEYS)
    return nets, bank, 4 * entries


def dp_path(workdir, paths):
    """Phase 3g: one coarse epoch of phase 3's subject, with its IGR and
    skinner caches, through the train CLI without --mesh and with --mesh
    dp=1 (one spawned rank over NCCL), each with torch's default
    algorithms and with its deterministic ones; with a second card, dp=2
    as well.  The plain path's colour and normal losses sum each frame's
    rays with index_add's float atomics, so two runs of it differ in
    those sums' last bits; with the deterministic algorithms the dp=1 run
    must give every info value of every step bit for bit."""
    import torch
    from selfreconcode_tpu_torch.cli import train as cli

    mesh1 = ["--mesh", "dp=1"]
    runs = [("plain", [], False), ("dp=1", mesh1, False),
            ("plain, deterministic", [], True),
            ("dp=1, deterministic", mesh1, True)]
    if torch.cuda.device_count() >= 2:
        runs.append(("dp=2, deterministic", ["--mesh", "dp=2"], True))
    else:
        print(f"  dp=2 skipped: {torch.cuda.device_count()} card(s), it "
              f"needs 2", flush=True)
    out = {}
    for tag, extra, det in runs:
        root = osp.join(workdir, "dp_" + re.sub(r"\W+", "_", tag))
        shutil.copytree(osp.join(workdir, "scene"), root,
                        ignore=shutil.ignore_patterns("rec*"))
        record = root + ".json"
        t0 = time.perf_counter()
        try:
            tr, launched = counted(cli.main, [
                "--conf", osp.join(ROOT, "configs", "config.conf"), "--data",
                root, "--save-folder", "rec", "--max-epochs", "0",
                "--device", "cuda"] + extra, tune=StepRecorder(record, det))
        finally:
            torch.use_deterministic_algorithms(False)
        wall = time.perf_counter() - t0
        rec = json.load(open(record))
        if extra:
            if tr is not None or any(launched.values()):
                raise AssertionError(f"{tag}: main returned {tr}, launches "
                                     f"in the calling process {launched}")
            launched = rec["launches"]
        elif any(launched.values()):
            # the recorder reads the counters after each step, which
            # clears them: what is left launched outside the steps
            raise AssertionError(f"{tag}: launches outside the recorded "
                                 f"steps {launched}")
        else:
            launched = rec["launches"]
        check_steps(rec["history"], 6144, 4, tag)
        exact_launches(tag, launched, splat_fwd=12, splat_bwd=12,
                       mesh_raster=0)
        paths[f"3g {tag}"] = launched
        setup = ("" if rec["dp_setup"] is None else
                 f"; process group set up in {rec['dp_setup']:.3f} s")
        print(f"  {tag}: median step {statistics.median(rec['steps']):.3f} "
              f"s (steps {[round(x, 3) for x in rec['steps']]}); whole CLI "
              f"run {wall:.1f} s{setup}", flush=True)
        if tag == "plain":
            nets, bank, nbytes = allreduce_bytes(tr)
            print(f"  one data-parallel step all-reduces {nbytes} bytes: "
                  f"parameters {nets} (float32), bank {bank} and info", flush=True)
        out[tag] = rec["history"]

    def differing(a, b):
        """{key: largest relative difference over the steps} where the
        two histories differ."""
        rel = {}
        for x, y in zip(a, b):
            for k in x:
                if x[k] != y[k]:
                    rel[k] = max(rel.get(k, 0.0),
                                 abs(x[k] - y[k]) / max(abs(x[k]), 1e-30))
        return {k: float(f"{v:.3e}") for k, v in rel.items()}

    for a, b in (("plain", "dp=1"), ("plain", "plain, deterministic"),
                 ("plain, deterministic", "dp=1, deterministic")):
        diff = differing(out[a], out[b])
        print(f"  {b} vs {a}: info values that differ (largest relative "
              f"difference over the 4 steps): {diff or 'none, bit for bit'}"
              f"; losses {[h['loss'] for h in out[b]]}", flush=True)
    if out["dp=1, deterministic"] != out["plain, deterministic"]:
        raise AssertionError("with deterministic algorithms the dp=1 run "
                             "is not the plain run bit for bit")
    if "dp=2, deterministic" in out:
        rel = max(abs(a["loss"] - b["loss"]) / abs(a["loss"])
                  for a, b in zip(out["dp=1, deterministic"],
                                  out["dp=2, deterministic"]))
        print(f"  dp=2 vs dp=1: largest relative loss difference "
              f"{rel:.3e}", flush=True)
        if rel > 1e-3:
            raise AssertionError(f"dp=2 losses differ from dp=1's by {rel}")


def ab_path(workdir, schedule_root, paths):
    """Phase 3f: the two A/B tools through their entry points, one
    variant a call so that each call's launches can be held to that
    variant: ab_stage_resume from phase 3e's coarse.pt into one medium
    epoch (base, ref_exact; 4 eval frames), and ab_convergence for 6
    coarse steps on phase 3's subject and IGR cache (base, cauchy; 8 eval
    frames)."""
    from selfreconcode_tpu_torch.tools import ab_convergence as AB
    from selfreconcode_tpu_torch.tools import ab_stage_resume as ABR

    def drive(tool, argv, variants, want):
        out = []
        for v in variants:
            (res,), launched = counted(tool.main, argv + ["--variants", v])
            path = f"{tool.__name__.rsplit('.', 1)[1]} {v}"
            exact_launches(path, launched, **want(v))
            paths[path] = launched
            bad = [k for k in ("maskE", "ray_frac")
                   if not (math.isfinite(res[k]) and 0.0 <= res[k] <= 1.0)]
            if bad or not all(math.isfinite(res[k]) for k in
                              ("loss", "mask_loss", "color_loss")):
                raise AssertionError(f"{v}: {res}")
            if (AB.VARIANTS[v].get("surf_newton", True) is False
                    and max(res["rays"]) < 1):
                raise AssertionError(f"{v}: the Cauchy solve converged no "
                                     f"ray in any step, so no IFT gradient "
                                     f"ran: {res['rays']}")
            out.append(res)
        return out

    resume = ["--root", schedule_root, "--ckpt", "coarse.pt", "--stage",
              "medium", "--epochs", "1", "--eval-frames", "4", "--device",
              "cuda"]
    # one medium epoch of 12 frames, N = 2: 6 steps of 2 frames
    res_r = drive(ABR, resume, ("base", "ref_exact"), lambda v: {
        "splat_fwd": 12, "splat_bwd": 12,
        "mesh_raster": 4 + (12 if v == "ref_exact" else 0)})
    ABR.print_table(res_r, ABR.parse_args(resume))
    conv = ["--steps", "6", "--root", osp.join(workdir, "scene"),
            "--device", "cuda"]
    # 6 coarse steps of 3 frames, then 8 eval frames
    res_c = drive(AB, conv, ("base", "cauchy"), lambda v: {
        "splat_fwd": 18, "splat_bwd": 18, "mesh_raster": 8})
    AB.print_table(res_c)


def write_uvmap(path, verts, faces):
    """A UV'd OBJ of the template (the file the reference asks its user to
    make): a cylindrical UV around the body's vertical axis, faces_vt =
    faces_v."""
    import numpy as np
    v = verts.detach().cpu().numpy().astype(np.float64)
    f = faces.cpu().numpy() + 1
    c = v.mean(0)
    u = np.arctan2(v[:, 0] - c[0], v[:, 2] - c[2]) / (2.0 * np.pi) + 0.5
    h = (v[:, 1] - v[:, 1].min()) / np.ptp(v[:, 1])
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("".join(f"v {a:.6f} {b:.6f} {z:.6f}\n" for a, b, z in v))
        fh.write("".join(f"vt {a:.6f} {b:.6f}\n" for a, b in zip(u, h)))
        fh.write("".join(f"f {a}/{a} {b}/{b} {z}/{z}\n" for a, b, z in f))


def texture_path(workdir, paths):
    """Phase 4b: the texture CLIs on phase 3b's 1080^2 subject and its
    fine-stage checkpoint: prepare --num 4, extract --tex-size 1024 (one
    mesh-kernel launch per baked frame); then the bake held to the CPU on
    tex_predata.npz's inputs (``bake_on_cpu``).  Returns (the bake's frame-0
    mesh, its faces, the camera) for shape T."""
    import torch
    from selfreconcode_tpu_torch.cli import texture as tcli
    from selfreconcode_tpu_torch.render.camera import make_camera

    rec = osp.join(workdir, "fine", "rec")
    prep, launched = counted(tcli.prepare, [
        "--rec-root", rec, "--num", "4", "--synthetic-body", "--device",
        "cuda"])
    paths["texture prepare"] = launched
    res, launched = counted(tcli.extract, [
        "--rec-root", rec, "--tex-size", "1024", "--device", "cuda"])
    n = res["frames"]
    print(f"  prepare_s {prep['seconds']:.3f} (deformed {prep['def_vs_shape']}"
          f"); bake_s_per_frame {res['bake_s'] / n:.4f} over {n} frames; "
          f"coverage {res['coverage']:.4f}; texture {res['tex_shape']}",
          flush=True)
    need_launches("texture bake", launched, mesh_raster=n)
    if launched["mesh_raster"] != n:
        raise AssertionError(f"the bake launched the mesh kernel "
                             f"{launched['mesh_raster']} times for {n} "
                             f"frames")
    if res["tex_shape"] != (1024, 1024, 3) or not res["coverage"] > 0:
        raise AssertionError(f"texture {res['tex_shape']}, coverage "
                             f"{res['coverage']}")
    paths["texture bake"] = launched
    d, imgs = tcli.load_predata(rec)
    cams = {dev: make_camera(d["focal"], d["princeple"], d["quat"], d["T"],
                             int(d["H"]), int(d["W"]), device=dev)
            for dev in ("cuda", "cpu")}
    bake_on_cpu(cams, d, imgs)
    return (torch.as_tensor(d["def_vs"][0], device="cuda"),
            torch.as_tensor(d["faces_v"], device="cuda").long(), cams["cuda"])


def bake_on_cpu(cams, d, imgs):
    """The bake on the card held to the same bake on the CPU, on
    tex_predata.npz's inputs, half by half on identical inputs (the
    rasterizer itself is held to its plain version by shape T).  The view
    weights |n.v|^8 of frame 0, from the card's fragments on both devices:
    within WEIGHT_TOL (the card sums the vertex normals with atomic adds in
    another order).  The aggregation (two stable sorts, the strictly-greater
    slot insert, the even-count median over inf-padded sorts) of all the
    frames, from the card's fragments and weights on both devices: texture
    and weight within 1e-6 (no tie can resolve otherwise on equal inputs).
    The whole per-frame pass is not held across devices: the projection's
    matmul rounds differently on each (its largest difference is printed),
    which moves pixels on an edge, or at a depth tie, to the other face."""
    import numpy as np
    import torch
    from selfreconcode_tpu_torch.ops.rasterize import (Fragments,
                                                       rasterize_mesh)
    from selfreconcode_tpu_torch.render.camera import transform_points_screen
    from selfreconcode_tpu_torch.texture.uv import (accumulate_texture,
                                                    view_weights)
    faces = {dev: torch.as_tensor(d["faces_v"], device=dev).long()
             for dev in cams}
    verts = {dev: [torch.as_tensor(v, device=dev) for v in d["def_vs"]]
             for dev in cams}
    cam, f_c, v_c = cams["cuda"], faces["cuda"], verts["cuda"]
    with torch.no_grad():
        frags = [rasterize_mesh(cam, v, f_c, 32) for v in v_c]
        card = [view_weights(cam, v, f_c, fr, 8.0)
                for v, fr in zip(v_c, frags)]
        t0 = time.perf_counter()
        cpu0 = view_weights(cams["cpu"], verts["cpu"][0], faces["cpu"],
                            Fragments(*(x.cpu() for x in frags[0])), 8.0)
        cpu_s = time.perf_counter() - t0
        proj_diff = float((transform_points_screen(cam, v_c[0]).cpu()
                           - transform_points_screen(
                               cams["cpu"], verts["cpu"][0])).abs().max())
    w_err = float((card[0][2].cpu() - cpu0[2]).abs().max())
    out = {}
    for dev in ("cuda", "cpu"):
        frs = [tuple(x.to(dev) for x in f) for f in card]
        t0 = time.perf_counter()
        out[dev] = accumulate_texture(frs, imgs, d["faces_vt"], d["uvs"],
                                      1024, 8, dev)
        out[dev + "_s"] = time.perf_counter() - t0
    tex_err = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    wsum_err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    print(f"  bake, card vs CPU: frame 0's projection max diff "
          f"{proj_diff:.3g} (px, px, m); view weights from the card's "
          f"fragments ({cpu_s:.2f} s on the CPU) max err {w_err:.3g}; "
          f"aggregation of {len(card)} frames ({out['cuda_s']:.3f} s card, "
          f"{out['cpu_s']:.2f} s CPU) texture max err {tex_err:.3g}, weight "
          f"max err {wsum_err:.3g}; {int((out['cuda'][1] > 0).sum())} texels "
          f"filled", flush=True)
    if w_err > WEIGHT_TOL or tex_err > 1e-6 or wsum_err > 1e-6:
        raise AssertionError("the bake on the card is not the CPU's")


def finite_in(x, lo=-math.inf, hi=math.inf):
    return isinstance(x, (int, float)) and math.isfinite(x) and lo <= x <= hi


def acceptance_path(workdir, paths):
    """Phase 3h: the acceptance flow (``tools.acceptance_run``) on a
    12-frame 1080^2 subject with phase 3's IGR and skinner caches, the
    schedule of phase 3e (medium from epoch 1, fine from epoch 2, 2 epochs
    after the first), inference of 4 frames; then ``tools.host_mask_eval``
    on those 4 frames.  Returns the subject's root."""
    from selfreconcode_tpu_torch.tools import acceptance_run as ACC
    from selfreconcode_tpu_torch.tools import host_mask_eval as HME

    root = osp.join(workdir, "accept")
    os.makedirs(root)
    for cache in ("initial_sdf_idr_6_1_torch.pt",
                  "initial_skinner_1_torch.pt"):
        shutil.copyfile(osp.join(workdir, "scene", cache),
                        osp.join(root, cache))
    conf = stage_conf(workdir, "accept.conf", 1, 2)
    out, launched = counted(ACC.main, [
        root, "12", "2", "--conf", conf, "--h", "1080", "--infer-frames",
        "4", "--device", "cuda"])
    # the render (1 mesh a frame), 12 frames a stage through the splat
    # kernels and the fine epoch's debug dump (1 splat mask, 1 mesh), then
    # inference (2 mesh a frame)
    exact_launches("acceptance", launched, splat_fwd=37, splat_bwd=36,
                   mesh_raster=12 + 1 + 2 * 4)
    paths["acceptance"] = launched
    steps = {name: n for name, _, n in SCHEDULE}
    print(f"  acceptance at 1080x1080: train {out['train_s']:.1f} s, infer "
          f"{out['infer_s']:.1f} s; per stage (median s/step, epoch s): "
          f"{ {k: (v['median_s_per_step'], v['epoch_s']) for k, v in out['stages'].items()} }; "
          f"projected onto config.conf's 201 epochs at 450 frames "
          f"({out['projected_steps']} steps) from this run's "
          f"{out['projected_from']} steps: {out['projected_h']:.2f} h; "
          f"maskE mean {out['maskE_mean']}; canonical Chamfer "
          f"{out['chamfer_l1_mm']} mm (L1), {out['chamfer_l2_mm2']} mm^2 "
          f"(L2), normal consistency {out['normal_consistency']}",
          flush=True)
    if out["projected_from"] != steps:
        raise AssertionError(f"steps per stage {out['projected_from']}, not "
                             f"{steps}")
    bad = [k for k, lo, hi in (
        ("chamfer_l1_mm", 0, math.inf), ("chamfer_l2_mm2", 0, math.inf),
        ("normal_consistency", 0, 1), ("maskE_mean", 0, 1),
        ("maskE_max", 0, 1), ("maskE_min", 0, 1),
        ("projected_h", 0, math.inf)) if not finite_in(out[k], lo, hi)]
    if bad:
        raise AssertionError(f"acceptance values out of range: "
                             f"{ {k: out[k] for k in bad} }")
    if not osp.isfile(osp.join(root, "gt_canonical.npz")):
        raise AssertionError("no gt_canonical.npz")

    hm, launched = counted(HME.main, ["--root", root, "--frames", "4",
                                      "--device", "cuda"])
    exact_launches("host_mask_eval", launched, splat_fwd=0, splat_bwd=0,
                   mesh_raster=0)
    paths["host_mask_eval"] = launched
    print(f"  host_mask_eval: {hm}", flush=True)
    if hm["frames"] != 4 or not all(finite_in(hm[k], 0, 1) for k in (
            "hole_fraction", "excess_fraction", "maskE_clean_mean",
            "maskE_dirty_mean")):
        raise AssertionError(f"host_mask_eval: {hm}")
    return root


def timing_path(workdir, accept_root, paths):
    """Phase 3i: the timing tools at 1080^2 (profile_step coarse N=3 and
    fine N=1, bench_outer and bench_remesh on the fine stage), bench_infer
    on 3h's checkpoint, parity_sweep at the fine resolutions, and
    bench_throughput at 512^2 fine with 6144 rays."""
    from selfreconcode_tpu_torch.engine.trainer import bench_throughput
    from selfreconcode_tpu_torch.tools import bench_infer as BI
    from selfreconcode_tpu_torch.tools import bench_outer as BO
    from selfreconcode_tpu_torch.tools import bench_remesh as BR
    from selfreconcode_tpu_torch.tools import parity_sweep as PSW
    from selfreconcode_tpu_torch.tools import profile_step as PS

    prof = ["--h", "1080", "--root", osp.join(workdir, "prof"), "--device",
            "cuda"]
    n_steps = 3
    for stage, n in (("coarse", 3), ("fine", 1)):
        _, launched = counted(PS.main, prof + ["--stage", stage, "--n",
                                               str(n), "--steps",
                                               str(n_steps)])
        # the inner pass: once to set up, then timed (1 warm, the steps, 1
        # profiled); train_step: 1 warm, the steps, 1 profiled; N frames
        k = n * (5 + 2 * n_steps)
        exact_launches(f"profile_step {stage}", launched, splat_fwd=k,
                       splat_bwd=k, mesh_raster=0)
        paths[f"profile_step {stage}"] = launched
    _, launched = counted(BO.main, prof + ["--stage", "fine", "--n", "1",
                                           "--iters", str(n_steps)])
    exact_launches("bench_outer", launched, splat_fwd=1, splat_bwd=1,
                   mesh_raster=0)
    paths["bench_outer"] = launched
    _, launched = counted(BR.main, prof + ["--stage", "fine", "--iters",
                                           "2"])
    paths["bench_remesh"] = launched
    frames, launched = counted(BI.main, ["--data", accept_root, "--frames",
                                         "2", "--device", "cuda"])
    exact_launches("bench_infer", launched, splat_fwd=0, splat_bwd=0,
                   mesh_raster=4)
    paths["bench_infer"] = launched
    if not all(finite_in(f["mask_err"], 0, 1) for f in frames):
        raise AssertionError(f"bench_infer: {frames}")
    igr_iters = 300
    print(f"  parity_sweep: --igr-iters {igr_iters}", flush=True)
    res, launched = counted(PSW.main, ["--stage", "fine", "--igr-iters",
                                       str(igr_iters), "--device", "cuda"])
    paths["parity_sweep"] = launched
    if res["res"] != (321, 417, 225) or not res["ok"]:
        raise AssertionError(f"parity_sweep: {res}")
    iters = 6
    (rate, detail), launched = counted(
        bench_throughput, sample_rays=6144, H=512, W=512, iters=iters,
        root=osp.join(workdir, "bench"), device="cuda")
    exact_launches("bench_throughput", launched, splat_fwd=1 + iters,
                   splat_bwd=1 + iters, mesh_raster=0)
    paths["bench_throughput"] = launched
    print(f"  bench_throughput (not a benchmark cell; 512x512 fine, 6144 "
          f"rays, {iters} steps): {rate:.3f} steps/s, {detail}", flush=True)
    if not finite_in(rate, 0):
        raise AssertionError(f"bench_throughput: {rate}")


def fine_path(workdir, paths):
    """Phase 3b: the fine stage at 1080^2 through the train CLI; returns
    the trainer."""
    from selfreconcode_tpu_torch.cli import train as cli

    root = osp.join(workdir, "fine")
    subject(root, 4, 1080, paths)
    for cache in ("initial_sdf_idr_6_1_torch.pt",
                  "initial_skinner_1_torch.pt"):
        shutil.copyfile(osp.join(workdir, "scene", cache),
                        osp.join(root, cache))
    conf_path = stage_conf(workdir, "fine.conf", -1, 0)
    loads = []

    def tune(t):    # called at the start (coarse) and at the fine switch
        if t.stage_cfg.name == "fine":
            time_loads(t.dataset, loads.append)

    t0 = time.perf_counter()
    trainer, launched = counted(cli.main, [
        "--conf", conf_path, "--data", root, "--save-folder", "rec",
        "--synthetic-body", "--max-epochs", "0", "--device", "cuda"],
        tune=tune)
    wall = time.perf_counter() - t0
    # epoch 0 of 4 one-frame steps: each 1080^2 frame decoded once (cold)
    print(f"  frame loads (cold decode of 1080x1080 frames): "
          f"{[round(x, 4) for x in loads]} s, {sum(loads) / len(loads):.4f} "
          f"s a frame", flush=True)
    if len(loads) != 4:
        raise AssertionError(f"{len(loads)} frame loads, not 4")
    cfg = trainer.stage_cfg
    tmp = trainer.tmp
    print(f"  stage {cfg.name}: N={cfg.N}, {trainer.rays_per_step()} rays, "
          f"radius {cfg.radius}, octree {cfg.resolutions[-1]}, raster "
          f"footprint {cfg.raster_footprint}; template {tmp.verts.shape[0]} "
          f"verts, {tmp.faces.shape[0]} faces, "
          f"{tmp.topo.edges.shape[0]} edges", flush=True)
    check_steps(trainer.history, trainer.rays_per_step(), 4, "fine")
    print_seconds(trainer, "fine", wall)
    if (cfg.name != "fine" or cfg.N != 1
            or cfg.resolutions != tuple(map(tuple, cli.RESOLUTIONS["fine"]))):
        raise AssertionError(f"not the fine stage: {cfg}")
    if trainer.timings["igr"] != 0.0:
        raise AssertionError("IGR ran again: the copied cache was not used")
    debug = osp.join(root, "rec", "debug")
    want = {"tmp.ply", "def_0.ply", "def1_0.ply", "m0.png", "gm0.png",
            "rgb0.png", "n0.png"}
    have = set(os.listdir(debug))
    print(f"  debug dump: {sorted(have)}", flush=True)
    if have != want:
        raise AssertionError(f"debug dump {sorted(have)} != {sorted(want)}")
    need_launches("fine", launched, splat_fwd=5, splat_bwd=4, mesh_raster=1)
    paths["fine"] = launched
    decoders(root, trainer.dataset)
    return trainer


def decoders(root, dataset):
    """Phase 3b's loader check: the trainer's decoder; when it is the
    native loader, each 1080^2 frame (image, mask, normal) decoded by it
    must be bitwise cv2's, and a cold frame is timed both ways (a fresh
    dataset each, one frame a call)."""
    import numpy as np
    from selfreconcode_tpu_torch.data.dataset import SceneDataset
    print(f"  frames decoded by: {dataset.decoder}", flush=True)
    if dataset.decoder != "native":
        return
    nat = SceneDataset(root, use_native=True)
    ref = SceneDataset(root, use_native=False)
    times = {"native": [], "cv2": []}
    for fid in range(dataset.frame_num):
        got = {}
        for name, ds in (("native", nat), ("cv2", ref)):
            t0 = time.perf_counter()
            got[name] = ds.frame_data(fid)
            times[name].append(time.perf_counter() - t0)
        a, b = got["native"], got["cv2"]
        if a.keys() != b.keys() or "normal" not in a or not all(
                np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError(f"frame {fid}: the native decode "
                                 f"({sorted(a)}) is not cv2's ({sorted(b)})")
    print(f"  native frames bitwise equal to cv2's (image, mask, normal) "
          f"for all {dataset.frame_num}; cold 1080x1080 frame: native "
          f"{[round(t, 4) for t in times['native']]} s (mean "
          f"{statistics.mean(times['native']):.4f}), cv2 "
          f"{[round(t, 4) for t in times['cv2']]} s (mean "
          f"{statistics.mean(times['cv2']):.4f})", flush=True)


def fragment_path(trainer, paths):
    """Phase 3c: 2 steps seeded from fragments with the three mesh
    regularizers on."""
    import numpy as np

    ray_fine = [int(h["ray_converged"]) for h in trainer.history]
    w = dataclasses.replace(trainer.stage_cfg.weights, laplacian_weight=10.0,
                            edge_weight=10.0, norm_weight=0.001)
    trainer.override_stage(point_inits=False, weights=w)
    ds = trainer.dataset

    def steps():
        out = []
        for fid in range(2):
            fids = np.array([fid])
            out.append(trainer.train_step(fids, ds.batch_raw(fids), 1e-4))
        return out

    t0 = time.perf_counter()
    hist, launched = counted(steps)
    wall = time.perf_counter() - t0
    check_steps(hist, trainer.rays_per_step(), 2, "fragment-seeded")
    print(f"  ray_converged: fragment-seeded "
          f"{[int(h['ray_converged']) for h in hist]}, vertex-seeded (3b) "
          f"{ray_fine}; regularizers "
          f"{[{k: h[k] for k in ('pc_lap_loss', 'pc_edge_loss', 'pc_norm_loss')} for h in hist]}; "
          f"{wall:.3f} s for 2 steps", flush=True)
    need_launches("fragment-seeded", launched, mesh_raster=2, splat_fwd=2,
                  splat_bwd=2)
    paths["fragments"] = launched


def infer_path(workdir, paths):
    """Phase 4: drive the port's infer CLI with --synthetic-body on phase
    3's checkpoint; returns (the inference template deformed into frame 0
    as the geometry pass deforms it, its faces, the camera)."""
    import numpy as np
    import torch
    from selfreconcode_tpu_torch.cli import infer as icli
    from selfreconcode_tpu_torch.models.deformer import deformer_apply

    rec = osp.join(workdir, "scene", "rec")
    n_frames = 2
    t0 = time.perf_counter()
    summary, launched = counted(icli.main, [
        "--rec-root", rec, "--synthetic-body", "--frames", str(n_frames),
        "--nV", "--device", "cuda"])
    wall = time.perf_counter() - t0
    print(f"  template: {summary['template_verts']} verts, "
          f"{summary['template_faces']} faces, remesh "
          f"{summary['template_s']:.3f} s", flush=True)
    for fr in summary["frames"]:
        print(f"  frame {fr['fid']}: geometry {fr['geom_s']:.3f} s, colour "
              f"{fr['color_s']:.3f} s, hit pixels {fr['hit_pixels']}, "
              f"converged {fr['converged_pixels']}, maskE "
              f"{fr['mask_err']:.6f} (against the body's own silhouettes)",
              flush=True)
    print(f"  whole CLI run {wall:.1f} s", flush=True)

    lines = open(osp.join(rec, "errors.txt")).read().splitlines()
    head = re.fullmatch(r"maskE, mean: (\S+), max: (\S+), min: (\S+)",
                        lines[0])
    errs = np.array([float(re.fullmatch(rf"{i}: (\S+)", ln).group(1))
                     for i, ln in enumerate(lines[2:])])
    done = errs[errs >= 0]
    if head is None or lines[1] != "maskE:" or len(done) != n_frames:
        raise AssertionError(f"errors.txt malformed or {len(done)} frames "
                             f"evaluated: {lines[:4]}")
    if not all(math.isfinite(e) and 0.0 <= e <= 1.0 for e in done):
        raise AssertionError(f"maskE out of [0, 1]: {done}")
    need_launches("inference", launched, mesh_raster=2 * n_frames)
    paths["inference"] = launched
    if not osp.isfile(osp.join(rec, "colors", "0.png")):
        raise AssertionError("no colors/0.png")
    if not all(fr["hit_pixels"] > 0 for fr in summary["frames"]):
        raise AssertionError("a frame rasterized no pixel")
    tr = summary["trainer"]
    nv = tr.tmp.verts.shape[0]
    with torch.no_grad():
        verts0, _ = deformer_apply(
            tr.nets.translator, tr.skinner, tr.tmp.verts,
            torch.zeros(nv, dtype=torch.long, device=tr.device),
            tr.bank["dcond"][:1], tr.bank["poses"][:1], tr.bank["trans"][:1],
            1.0)
    return verts0, tr.tmp.faces, tr.camera()


def profile_step(trainer):
    """One more step of the trainer's stage under torch.profiler: prints
    the device busy share and the top 40 ops by device time."""
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
    splat_ms = sum(e.self_device_time_total for e in avg
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "splat" in e.key) / 1e3
    print(f"  profiled {trainer.stage_cfg.name} step: wall "
          f"{wall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%), splat "
          f"kernels {splat_ms:.3f} ms ({100 * splat_ms / busy_ms:.2f}% of "
          f"device time)", flush=True)
    print(avg.table(sort_by="self_device_time_total", row_limit=40),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3 and 3b, profile one more coarse "
                         "and one more fine step")
    args = ap.parse_args(argv)

    card = device_phase()
    import torch
    from selfreconcode_tpu_torch.data.synthetic_subject import (
        DISTANCE, render_mesh, subject_rig, subject_trajectory)
    from selfreconcode_tpu_torch.ops import mesh_kernels as MK
    from selfreconcode_tpu_torch.ops import splat_kernels as SK
    from selfreconcode_tpu_torch.render.camera import Camera, make_camera

    t0 = time.perf_counter()
    libs = (SK.LIB, MK.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(lambda lib: lib.build(verbose=True), libs))
    for lib in libs:
        lib.load()
    phase(2, f"built {[str(p.relative_to(ROOT)) for p in built]} in "
             f"{time.perf_counter() - t0:.2f} s (one nvcc each, together)")

    dev = torch.device("cuda")
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        phase(3, "training path: a 12-frame 512x512 subject of the 6890-"
                 "vertex body, cli.train.main with the body's pickle")
        trainer = main_path(work, paths)
        if args.profile:
            profile_step(trainer)
        with torch.no_grad():
            pts_b = trainer.deformed_template([0])[0]
        cam_b = trainer.camera()
        phase("3d", "resume through the checkpoint interchange: a reference "
                    ".pth, then --sdf-model a bare SDF .pth")
        interchange_path(work, trainer, paths)
        del trainer
        phase("3e", "the three-stage schedule: coarse -> medium -> fine on "
                    "phase 3's subject, cli.train.main --max-epochs 2")
        schedule_root = schedule_path(work, paths)
        phase("3f", "the A/B tools: ab_stage_resume from 3e's coarse.pt "
                    "(base, ref_exact), ab_convergence on phase 3's "
                    "subject (base, cauchy)")
        ab_path(work, schedule_root, paths)
        phase("3g", "data parallel: one coarse epoch of phase 3's subject "
                    "through cli.train.main, plain and --mesh dp=1 (NCCL)")
        dp_path(work, paths)
        phase("3b", "fine stage: a 4-frame 1080x1080 subject, 4 fine steps "
                    "and the debug dump")
        fine = fine_path(work, paths)
        if args.profile:
            profile_step(fine)
        with torch.no_grad():
            pts_e = fine.deformed_template([0])[0]
        cam_e, radius_e = fine.camera(), fine.stage_cfg.radius
        faces_f, footprint_f = fine.tmp.faces, fine.stage_cfg.raster_footprint
        phase("3c", "2 fine steps seeded from fragments, mesh regularizers "
                    "on")
        fragment_path(fine, paths)
        write_uvmap(osp.join(work, "fine", "rec", "template", "uvmap.obj"),
                    fine.tmp.verts, fine.tmp.faces)
        del fine
        phase(4, "inference path: cli.infer.main --synthetic-body on the "
                 "phase-3 checkpoint")
        verts_c, faces, cam_c = infer_path(work, paths)
        phase("4b", "texture: cli.texture prepare --num 4 and extract "
                    "--tex-size 1024 on phase 3b's checkpoint")
        verts_t, faces_t, cam_t = texture_path(work, paths)
        phase("3h", "acceptance at 1080x1080: tools.acceptance_run on a "
                    "12-frame subject (coarse -> medium -> fine, 4 "
                    "inferred frames), then tools.host_mask_eval")
        accept_root = acceptance_path(work, paths)
        phase("3i", "timing: profile_step (coarse, fine), bench_outer, "
                    "bench_remesh, bench_infer, parity_sweep, "
                    "bench_throughput")
        timing_path(work, accept_root, paths)
    launched = {k: sum(p[k] for p in paths.values()) for k in
                next(iter(paths.values()))}
    print(f"  launches per path: {json.dumps(paths)}; in all {launched} "
          f"(the dense splat forms have no caller)", flush=True)

    phase(5, f"splat kernels vs plain on the card ({card})")
    H = W = 1080
    cam_a = make_camera([0.9 * W] * 2, [W / 2, H / 2], [1, 0, 0, 0],
                        [0, 0, 2.5], H, W, device=dev)
    pts_a = torch.tensor(shell_points(134000, (0.18, 0.75, 0.11), 0),
                         device=dev)
    res_a = compare_kernels("A 1080x1080 134k pts r=0.0041", cam_a, pts_a,
                            0.0041, 1)
    label_b = f"B 512x512 {pts_b.shape[0]} pts r=0.006"
    res_b = compare_kernels(label_b, cam_b, pts_b, 0.006, 2)
    # E: what the fine stage feeds the kernels
    res_e = compare_kernels(f"E 1080x1080 {pts_e.shape[0]} pts "
                            f"r={radius_e}", cam_e, pts_e, radius_e, 4)
    res_bd = compare_dense(label_b + " dense", cam_b, pts_b, 0.006, 3)
    # R: 50k splats on circles of radius r around pixel centres (w ~ 0)
    rim = torch.tensor(rim_points(50000, 0.006 * cam_b.W / 2, cam_b.W, 6),
                       device=dev)
    res_r = compare_kernels("R 512x512 50k rim pts r=0.006", cam_b, None,
                            0.006, 5, screen=rim)

    phase(6, f"mesh kernel vs plain on the card ({card})")
    res_c = compare_mesh(f"C 512x512 {faces.shape[0]} faces", cam_c,
                         verts_c, faces)
    # C-dup: C's faces twice over, so every hit pixel is an exact depth tie
    res_cd = compare_mesh(f"C-dup 512x512 {2 * faces.shape[0]} faces", cam_c,
                          verts_c, torch.cat([faces, faces]),
                          first_faces=faces.shape[0])
    k = 1080 / cam_c.W
    cam_d = Camera(focal=cam_c.focal * k, principal=cam_c.principal * k,
                   R=cam_c.R, T=cam_c.T, H=1080, W=1080)
    res_d = compare_mesh(f"D 1080x1080 {faces.shape[0]} faces", cam_d,
                         verts_c, faces)
    # F: what fragment seeding and the debug dump rasterize in the fine
    # stage, at the stage's footprint
    res_f = compare_mesh(f"F 1080x1080 {faces_f.shape[0]} faces fp "
                         f"{footprint_f}", cam_e, pts_e, faces_f,
                         footprint=footprint_f)
    # S: frame 0 of phase 3b's subject, the render mesh at its footprint
    rig = subject_rig(1080, 1080, device="cuda")
    poses, trans = subject_trajectory(4)
    with torch.no_grad():
        verts_s = render_mesh(rig, torch.as_tensor(poses[0], device=dev),
                              torch.as_tensor(trans[0] + DISTANCE,
                                              device=dev))
    res_s = compare_mesh(f"S 1080x1080 {rig.faces.shape[0]} faces fp "
                         f"{rig.footprint}", rig.cam, verts_s, rig.faces,
                         footprint=rig.footprint)
    # T: the texture bake's frame-0 mesh (the deformed uvmap) at the bake's
    # footprint: the largest cells (32 px, 1024 keys a cell)
    res_t = compare_mesh(f"T 1080x1080 {faces_t.shape[0]} faces fp 32",
                         cam_t, verts_t, faces_t, footprint=32)
    mesh = {"C": res_c, "C-dup": res_cd, "D": res_d, "F": res_f,
            "S": res_s, "T": res_t}

    splat_src = "selfreconcode_tpu_torch/csrc/splat.cu"
    dense_note = "no caller in either package; launched by chip_smoke.py only"
    splat = {"A": res_a, "B": res_b, "E": res_e, "R": res_r}
    kernels = [
        kernel_row("mesh_raster",
                   "selfreconcode_tpu_torch/csrc/mesh_raster.cu", 116,
                   launched["mesh_raster"],
                   max(r[k] for r in mesh.values()
                       for k in ("z_max_abs_err", "bary_max_abs_err")),
                   {n: timings(r) for n, r in mesh.items()}, "D"),
        kernel_row("splat_fwd_cells", splat_src, 176,
                   launched["splat_fwd_cells"], res_bd["fwd_max_abs_err"],
                   {"B-dense": timings(res_bd, "fwd_")}, "B-dense",
                   note=dense_note),
        kernel_row("splat_fwd", splat_src, 231, launched["splat_fwd"],
                   max(r["mask_max_abs_err"] for r in splat.values()),
                   {n: timings(r, "fwd_") for n, r in splat.items()}, "E"),
        kernel_row("splat_bwd", splat_src, 287, launched["splat_bwd"],
                   max(r["bwd_max_abs_err"] for r in splat.values()),
                   {n: timings(r, "bwd_") for n, r in splat.items()}, "E"),
        kernel_row("splat_bwd_cells", splat_src, 342,
                   launched["splat_bwd_cells"], res_bd["bwd_max_abs_err"],
                   {"B-dense": timings(res_bd, "bwd_")}, "B-dense",
                   note=dense_note),
    ]
    phase(7, "results")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
