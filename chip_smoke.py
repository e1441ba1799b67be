"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile   # + one more step under torch.profiler

Phases:
  1. device: the card's name and power limit (nvidia-smi) and torch's view;
  2. build: one nvcc per CUDA source, all started together:
     csrc/splat.cu (the splat kernels) and csrc/mesh_raster.cu (the mesh
     rasterizer);
  3. training path: a 12-frame 512x512 synthetic scene through
     ``selfreconcode_tpu_torch.cli.train.main`` with configs/config.conf at
     full width (toy SMPL body, random weights from a seed), --max-epochs 0:
     skinner build, 1200 IGR iterations, remesh, 4 coarse steps, checkpoint.
     The splat kernels' launch counters are zeroed right before and read
     right after; both kernels must have run on that path;
  4. inference path: ``selfreconcode_tpu_torch.cli.infer.main`` on phase
     3's checkpoint, 2 frames (template remesh, Phong and def1 renders,
     maskE, colour solve).  The mesh kernel's counter is zeroed right before
     and read right after: >= 2 launches per frame; errors.txt must parse
     with 2 evaluated frames, each maskE finite and in [0, 1];
  5. splat kernels vs plain on the card at shape A (1080x1080 frame, 134k
     points on a body-sized shell, radius 0.0041), shape B (the trained
     template deformed into frame 0 of the 512x512 scene, radius 0.006),
     shape E (the same template at 1080x1080, focal and principal point
     scaled by 1080/512, radius 0.0041: what the fine stage feeds them) and
     shape R (50k splats each at distance r from a pixel centre, where the
     backward's coefficient jumps: the kernels must round w as the plain
     version does), and the dense-cell forms at shape B's bins laid out
     densely.  Each kernel runs twice and must give the same bits;
  6. mesh kernel vs plain on the card at shape C (phase 4's template, the
     remesh of the trained SDF, deformed into frame 0 at 512x512 as the
     geometry pass deforms it), shape C-dup (C's faces twice over: every
     hit is an exact depth tie, which the first copy must win) and shape D
     (C at 1080x1080, focal and principal point scaled by 1080/512).  Each
     launch runs twice and must give the same bits;
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
import json
import math
import os.path as osp
import re
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
# mesh kernel vs plain: the kernel is built with -fmad=false and rounds like
# the plain version, and both keep the first minimum in run order, so every
# output must be identical: hit mask, z, face id and barycentrics


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
    Forward: reads the distinct points, the M entries and their cells and
    the n_cells per-cell arrays, and writes the active cells' pixels (with
    1 - exp(acc) on each when fused).  Backward: reads the points, entries
    and entry cells, and on the active cells' pixels the mask's gradient
    and the mask (fused: it forms -g (1 - mask) there) or the cotangent,
    and writes M gradient pairs."""
    px = work["cell_px"]
    ins = 8 * work["points"] + 8 * M
    fwd = bound_us(OPS_PAIR * work["bbox_pairs"]
                   + OPS_LOG1P * work["fwd_hits"] + fused * OPS_EXP * px,
                   ins + 12 * n_cells + 4 * px)
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
        fargs = (col, row, b.entries, b.ecell, b.cell_ids, b.starts,
                 b.counts, b.cs, b.ncx, H, W, r2_inv)
        gen = torch.Generator(device=s.device).manual_seed(seed)
        g_img = torch.randn((H, W), generator=gen, device=s.device)

        mask_k = SK.splat_fwd(*fargs)
        mask_p = SK.splat_fwd_plain(*fargs)
        acc_k = SK.splat_fwd(*fargs, to_mask=False)
        acc_p = SK.splat_fwd_plain(*fargs, to_mask=False)
        bargs = (col, row, b.entries, b.ecell, g_img, mask_k, b.cs, b.ncx,
                 r2_inv, 4 * n)
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
        work = splat_work(col, row, b.entries, b.cell_ids, b.counts, b.cs,
                          b.ncx, r2_inv, H, W)
        (fb, fby), (bb, bby) = splat_bounds(
            work, b.entries.numel(), b.cell_ids.numel(), fused=True)
        fcall, bcall = SK.fwd_call(*fargs), SK.bwd_call(*bargs)
        out = {
            "shape": label, "n_pts": int(s.shape[0]),
            "entries": int(b.entries.numel()),
            "active_cells": int(b.cell_ids.numel()),
            "max_occupancy": int(b.counts.max()), **work,
            "fwd_max_err": fwd_err, "mask_max_abs_err": mask_err,
            "bwd_max_abs_err": bwd_err,
            "bwd_max_abs_g": gmax, "bit_identical": same,
            "fwd_device_us": device_us(fcall),
            "fwd_device_cold_us": device_cold_us(fcall),
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
        C = (b.hp // b.cs) * b.ncx
        cap = -(-int(b.counts.max()) // 64) * 64
        counts = b.counts.long()
        cell = torch.repeat_interleave(b.cell_ids.long(), counts)
        slot = (torch.arange(b.entries.numel(), device=pts.device)
                - torch.repeat_interleave(b.starts.long(), counts))
        p = b.entries.long() % pts.shape[0]
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
        col_d, row_d, ent_d, _, cells_d, _, counts_d = bins
        work = splat_work(col_d, row_d, ent_d, cells_d, counts_d, b.cs, b.ncx,
                          r2_inv, hp, wp)
        (fb, fby), (bb, bby) = splat_bounds(work, ent_d.numel(), C,
                                            fused=False)
        fcall = SK.fwd_call(*bins, b.cs, b.ncx, hp, wp, r2_inv, to_mask=False)
        bcall = SK.bwd_call(*bins[:4], cot_img, None, b.cs, b.ncx, r2_inv,
                            C * cap)
        out = {
            "shape": label, "cells": C, "cap": cap,
            "filled_slots": int(b.entries.numel()), **work,
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


def compare_mesh(label, cam, verts, faces, first_faces=None):
    """The mesh kernel vs its plain version at one shape.  first_faces = F
    for a mesh whose faces are F faces twice over: every hit must then name
    a face < F (the first in run order wins the exact depth tie)."""
    import torch
    from selfreconcode_tpu_torch.ops import mesh_kernels as MK
    from selfreconcode_tpu_torch.ops.rasterize import mesh_bins

    H, W = cam.H, cam.W
    with torch.no_grad():
        rec, b = mesh_bins(cam, verts, faces, 8)
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
            "shape": label, "faces": int(faces.shape[0]), "cell_px": b.cs,
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


def infer_path(workdir):
    """Drive the port's infer CLI on phase 3's checkpoint; returns (the mesh
    kernel's launch count, the inference template deformed into frame 0 as
    the geometry pass deforms it, its faces, the camera)."""
    import numpy as np
    import torch
    from selfreconcode_tpu_torch.cli import infer as icli
    from selfreconcode_tpu_torch.models.deformer import deformer_apply
    from selfreconcode_tpu_torch.ops import mesh_kernels as MK

    rec = osp.join(workdir, "scene", "rec")
    n_frames = 2
    MK.launches.reset()
    t0 = time.perf_counter()
    summary = icli.main(["--rec-root", rec, "--toy-smpl", "--frames",
                         str(n_frames), "--nV", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = MK.launches.mesh_raster_launches
    print(f"  template: {summary['template_verts']} verts, "
          f"{summary['template_faces']} faces, remesh "
          f"{summary['template_s']:.3f} s", flush=True)
    for fr in summary["frames"]:
        print(f"  frame {fr['fid']}: geometry {fr['geom_s']:.3f} s, colour "
              f"{fr['color_s']:.3f} s, hit pixels {fr['hit_pixels']}, "
              f"converged {fr['converged_pixels']}, maskE "
              f"{fr['mask_err']:.6f}", flush=True)
    print(f"  mesh kernel launches {launches}; whole CLI run {wall:.1f} s",
          flush=True)

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
    if launches < 2 * n_frames:
        raise AssertionError(f"mesh kernel launched {launches} times; the "
                             f"inference path needs >= {2 * n_frames}")
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
    return launches, verts0, tr.tmp.faces, tr.camera()


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
    splat_ms = sum(e.self_device_time_total for e in avg
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "splat" in e.key) / 1e3
    print(f"  profiled step: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%), splat "
          f"kernels {splat_ms:.3f} ms ({100 * splat_ms / busy_ms:.2f}% of "
          f"device time)", flush=True)
    print(avg.table(sort_by="self_device_time_total", row_limit=40),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after phase 3, profile one more training step")
    args = ap.parse_args(argv)

    card = device_phase()
    import torch
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
    with tempfile.TemporaryDirectory() as work:
        phase(3, "training path: cli.train.main on a 12-frame 512x512 scene")
        trainer, launched = main_path(work)
        if args.profile:
            profile_step(trainer)
        with torch.no_grad():
            pts_b = trainer.deformed_template([0])[0]
        cam_b = trainer.camera()
        del trainer
        phase(4, "inference path: cli.infer.main on the phase-3 checkpoint")
        launched["mesh_raster"], verts_c, faces, cam_c = infer_path(work)
    # the dense splat forms have no caller: their counts, zeroed before
    # phase 3 and read after phase 4, cover both main paths
    launched["splat_fwd_cells"] = SK.launches.splat_fwd_cells_launches
    launched["splat_bwd_cells"] = SK.launches.splat_bwd_cells_launches
    print(f"  dense splat forms launched on the main paths: fwd "
          f"{launched['splat_fwd_cells']}, bwd {launched['splat_bwd_cells']}",
          flush=True)

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
    # E: what the fine stage feeds the kernels, B's template at 1080^2
    k = 1080 / cam_b.W
    cam_e = Camera(focal=cam_b.focal * k, principal=cam_b.principal * k,
                   R=cam_b.R, T=cam_b.T, H=1080, W=1080)
    res_e = compare_kernels(f"E 1080x1080 {pts_b.shape[0]} pts r=0.0041",
                            cam_e, pts_b, 0.0041, 4)
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

    splat_src = "selfreconcode_tpu_torch/csrc/splat.cu"
    dense_note = "no caller in either package; launched by chip_smoke.py only"
    splat = {"A": res_a, "B": res_b, "E": res_e, "R": res_r}
    kernels = [
        kernel_row("mesh_raster",
                   "selfreconcode_tpu_torch/csrc/mesh_raster.cu", 116,
                   launched["mesh_raster"],
                   max(r[k] for r in (res_c, res_cd, res_d)
                       for k in ("z_max_abs_err", "bary_max_abs_err")),
                   {"C": timings(res_c), "C-dup": timings(res_cd),
                    "D": timings(res_d)}, "D"),
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
