"""The warm remesh split into its parts (port of the repository's
``tools/bench_remesh.py``): the octree sweep (``sparse_sdf_grid`` over the
SDF at the stage's resolutions), marching cubes, the edge topology of the
faces (``build_edge_topology``, on the device in the port) and the whole
template build (``make_template``: the topology and zero momentum), each
timed as ``profile_step.timed`` times a pass (wall, span, busy), after a
cold remesh and --iters warm ``Trainer.remesh`` calls.  The trainer is
``profile_step``'s (the synthetic trainer at the production octree
resolutions).

    python -m selfreconcode_tpu_torch.tools.bench_remesh --h 1080 \\
        --stage fine --iters 3 [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import torch

from .profile_step import make_trainer, timed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--stage", default="coarse")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--root", default=None,
                    help="where the synthetic scene is written (default "
                         "<tmp>/srtpu_prof_<h>)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    args.small = False
    args.n = args.rays = args.data = args.model = None
    return args


def main(argv=None, resolutions=None) -> dict:
    """Entry point; returns {warm_remesh_ms: [...], part: timed dict}.
    resolutions is a test hook, as in profile_step."""
    from ..cli.train import open_device
    from ..engine.trainer import make_template
    from ..ops.marching_cubes import marching_cubes
    from ..ops.sparse_sdf import grid_world_coords, sparse_sdf_grid
    from ..utils.meshops import build_edge_topology

    args = parse_args(argv)
    args.device = dev = open_device(args.device)
    tr, _ = make_trainer(args, resolutions)      # its remesh is the cold one
    warm = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        nv, nf = tr.remesh(1.0)
        warm.append((time.perf_counter() - t0) * 1e3)
        print(f"warm remesh {warm[-1]:.1f} ms ({nv} verts {nf} faces)",
              flush=True)

    res = tuple(tuple(int(v) for v in r) for r in tr.stage_cfg.resolutions)
    query = tr._query_fn(1.0)
    spacing, origin = grid_world_coords(res[-1], tr.b_min, tr.b_max, dev)

    def sweep():
        with torch.no_grad():
            return sparse_sdf_grid(query, res, tr.b_min, tr.b_max, 0.0,
                                   device=dev)

    vol = sweep()
    mc = marching_cubes(vol, origin, spacing, 0.0)
    print(f"\nremesh parts at {res[-1]} (per call; {args.iters} calls back "
          f"to back):", flush=True)
    out = {"warm_remesh_ms": warm,
           "octree sweep": timed("octree sweep", sweep, args.iters, dev),
           "marching cubes": timed(
               "marching cubes", lambda: marching_cubes(vol, origin, spacing,
                                                        0.0), args.iters, dev),
           "edge topology": timed(
               "edge topology", lambda: build_edge_topology(mc.faces),
               args.iters, dev),
           "template build": timed(
               "template build (make_template)",
               lambda: make_template(mc.verts, mc.faces), args.iters, dev)}
    return out


if __name__ == "__main__":
    main()
