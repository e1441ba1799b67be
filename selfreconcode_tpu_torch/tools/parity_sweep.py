"""Sign-exact octree sweep against a dense evaluation of a trained SDF (port
of the repository's ``tools/parity_sweep.py``).

The SDF (``SDFNet`` at config.conf's width) is pretrained by IGR
(``igr_pretrain``, --igr-iters) on the synthetic body posed into the
canonical A-pose; the octree sweep (``sparse_sdf_grid``, the conflict loop
of --conflict-iters) then evaluates it at the stage's resolutions, and the
same SDF is evaluated densely at the last of them (fine: 321 x 417 x 225 =
30.1M points, in chunks of 2^19).  A sign mismatch anywhere is a cracked or
phantom marching-cubes triangle; the voxels next to a sign crossing, which
place the marching-cubes vertices, must hold the dense values.  Prints the
sweep's query count beside the dense one and a RESULT line:

    RESULT stage=fine res=(321, 417, 225) sign_mismatches=0 ...

    python -m selfreconcode_tpu_torch.tools.parity_sweep --stage fine \\
        [--igr-iters 1200] [--device cuda]

Exits 1 when the sweep is not sign-exact or a crossing-adjacent voxel is
off by 1e-5 or more.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..cli.train import RESOLUTIONS

CHUNK = 1 << 19


def crossing_adjacent(sign: torch.Tensor) -> torch.Tensor:
    """Voxels with a neighbour of the other sign along some axis."""
    cross = torch.zeros_like(sign)
    for ax in range(3):
        s, c = sign.movedim(ax, 0), cross.movedim(ax, 0)
        edge = s[:-1] != s[1:]
        c[:-1] |= edge
        c[1:] |= edge
    return cross


def dense_eval(query, res, b_min, b_max, device) -> torch.Tensor:
    """query at every voxel of the res grid, CHUNK points at a time."""
    from ..ops.sparse_sdf import grid_world_coords
    spacing, origin = grid_world_coords(res, b_min, b_max, device)
    W, H, D = res
    dense = torch.empty(W * H * D, device=device)
    for lo in range(0, dense.numel(), CHUNK):
        i = torch.arange(lo, min(lo + CHUNK, dense.numel()), device=device)
        idx = torch.stack([i // (H * D), i // D % H, i % D], dim=-1)
        dense[i] = query(origin + idx.float() * spacing)
    return dense.reshape(W, H, D)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default="fine", choices=list(RESOLUTIONS))
    ap.add_argument("--igr-iters", type=int, default=1200)
    ap.add_argument("--ratio", type=float, default=1.0)
    ap.add_argument("--conflict-iters", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None, resolutions=None, net_kw=None, body_kw=None) -> dict:
    """Entry point; returns the RESULT fields and `ok`.  resolutions (a
    stage's list), net_kw (SDFNet widths) and body_kw (the synthetic body's
    size) are test hooks."""
    from ..cli.train import open_device
    from ..engine.igr_init import igr_pretrain
    from ..models.sdf import SDFNet
    from ..models.smpl import smpl_forward, smpl_tmp_apose
    from ..models.synthetic_body import synthetic_body_model
    from ..ops.sparse_sdf import sparse_sdf_grid
    from ..utils import meshops

    args = parse_args(argv)
    dev = open_device(args.device)
    body = synthetic_body_model(**(body_kw or {}))
    with torch.no_grad():
        verts = smpl_forward(body, torch.zeros(1, 10, device=dev),
                             torch.as_tensor(smpl_tmp_apose(1),
                                             device=dev)[None])[0][0]
    faces = torch.as_tensor(body.faces, device=dev).long()
    normals = meshops.vertex_normals(verts, faces)
    margin = np.asarray([0.15, 0.15, 0.20], np.float32)
    v = verts.cpu().numpy()
    b_min, b_max = v.min(0) - margin, v.max(0) + margin

    net = SDFNet(**(net_kw or {})).to(dev)
    print(f"IGR pretrain {args.igr_iters} iters ...", flush=True)
    t0 = time.perf_counter()
    info = igr_pretrain(net, verts, normals, n_iters=args.igr_iters,
                        generator=torch.Generator(device=dev).manual_seed(7))
    print(f"  done in {time.perf_counter() - t0:.1f}s: {info}", flush=True)

    res = tuple(tuple(int(x) for x in r)
                for r in (resolutions or RESOLUTIONS[args.stage]))
    n_query = [0]

    def query(p):
        n_query[0] += p.shape[0]
        return torch.cat([net(c, args.ratio)[0]
                          for c in torch.split(p, CHUNK)])

    with torch.no_grad():
        t0 = time.perf_counter()
        vol = sparse_sdf_grid(query, res, b_min, b_max, 0.0,
                              conflict_iters=args.conflict_iters, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_sweep = time.perf_counter() - t0
        n_sweep, n_dense = n_query[0], int(np.prod(res[-1]))
        print(f"sweep {res[-1]}: {t_sweep:.2f}s ({n_sweep:,} queries of "
              f"{n_dense:,} dense)", flush=True)
        t0 = time.perf_counter()
        dense = dense_eval(query, res[-1], b_min, b_max, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"dense eval: {time.perf_counter() - t0:.2f}s", flush=True)

        mism = (vol > 0) != (dense > 0)
        cross = crossing_adjacent(vol > 0)
        cross_err = (float((vol[cross] - dense[cross]).abs().max())
                     if bool(cross.any()) else 0.0)
        out = {"stage": args.stage, "res": res[-1],
               "igr_iters": args.igr_iters,
               "sign_mismatches": int(mism.sum()),
               "crossing_adjacent_voxels": int(cross.sum()),
               "crossing_max_err": cross_err,
               "inside_frac": float((dense < 0).float().mean()),
               "sweep_queries": n_sweep, "dense": n_dense,
               "sweep_s": t_sweep}
    out["ok"] = out["sign_mismatches"] == 0 and cross_err < 1e-5
    print(f"RESULT stage={args.stage} res={res[-1]} "
          f"sign_mismatches={out['sign_mismatches']} "
          f"crossing_adjacent_voxels={out['crossing_adjacent_voxels']:,} "
          f"crossing_max_err={cross_err:.3e} "
          f"inside_frac={out['inside_frac']:.4f}", flush=True)
    if out["ok"]:
        print("PARITY OK: sweep is sign-exact vs dense and value-exact at "
              "every MC-visible voxel", flush=True)
    else:
        ii = torch.nonzero(mism)[:10]
        print("PARITY FAIL - first mismatches:\n", ii.tolist(),
              "\n dense:", dense[tuple(ii.T)].tolist(),
              "\n sweep:", vol[tuple(ii.T)].tolist(), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
