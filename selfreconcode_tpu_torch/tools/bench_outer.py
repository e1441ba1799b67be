"""The outer pass split into its parts (port of the repository's
``tools/bench_outer.py``): the surface solve, the loss forward, the
backward and the Adam update, each timed as ``profile_step.timed`` times
a pass (wall, span, busy).  The trainer is ``profile_step``'s (the
synthetic trainer at the production octree resolutions, remeshed).

  surface solve        ``solve_surface`` as the step runs it (on the card
                       a graph replay), then the IFT correction;
  surface solve + IFT  the same, then the backward of sum(pts);
  loss forward         ``outer_loss``: the solve and every loss term,
                       eagerly;
  outer pass           ``outer_pass``: the forward and its backward (on
                       the card a replay of the body's CUDA graph);
  backward             outer pass - loss forward (printed; on the card
                       the eager forward's host time less the graph's);
  Adam                 ``optimizer.step()`` on the outer pass's gradients.

    python -m selfreconcode_tpu_torch.tools.bench_outer --h 1080 \\
        --stage fine --n 1 --iters 10 [--device cuda]
"""
from __future__ import annotations

import argparse

from .profile_step import fmt_ms, make_trainer, step_passes, timed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--stage", default="coarse")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--root", default=None,
                    help="where the synthetic scene is written (default "
                         "<tmp>/srtpu_prof_<h>)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    args.small = False
    args.rays = args.data = args.model = None
    return args


def main(argv=None, resolutions=None, tune=None) -> dict:
    """Entry point; returns {part: timed dict} (backward: the difference).
    resolutions and tune(trainer) are test hooks, as in profile_step."""
    from ..cli.train import open_device
    from ..engine.surface import SurfaceConfig, ift_points, solve_surface
    from ..engine.trainer import camera_from_bank
    from ..models.skinner import fk_transforms
    from ..render.camera import cam_pos, view_rays
    import torch

    args = parse_args(argv)
    args.device = dev = open_device(args.device)
    tr, ds = make_trainer(args, resolutions, tune)
    _, _, outer, outer_args = step_passes(tr, ds)
    step, cfg, nets = tr._get_step_fn(), tr.stage_cfg, tr.nets
    (bank, _, _, _, fids, init_pts, _, rows, cols, binds, _, ratios,
     _) = outer_args
    surf_nets = (nets.sdf, nets.translator, tr.skinner)
    surf_cfg = SurfaceConfig(n_iters=cfg.surf_iters,
                             athreshold_deg=tr.ang_thresh,
                             newton=cfg.surf_newton)

    def solve():
        cam = camera_from_bank(bank, cfg.H, cfg.W, cfg)
        pix = torch.stack([cols.float(), rows.float(),
                           torch.ones(rows.shape[0], device=dev)], dim=-1)
        theta = (*ratios[:2], bank["dcond"][fids],
                 fk_transforms(tr.skinner, bank["poses"][fids])[0],
                 bank["trans"][fids], view_rays(cam, pix), cam_pos(cam))
        pts, done, B = solve_surface(surf_nets, surf_cfg, *theta, init_pts,
                                     binds, step.graph_caches(dev)[0])
        return ift_points(surf_nets, *theta, binds, pts, done, B), done

    def solve_ift():
        tr.optimizer.zero_grad(set_to_none=False)
        solve()[0].sum().backward()

    def adam():
        tr.optimizer.step()

    print(f"\nouter pass parts (per call; {args.iters} calls back to "
          f"back):", flush=True)
    out = {"surface solve": timed("surface solve", solve, args.iters, dev),
           "surface solve + IFT bwd": timed("surface solve + IFT bwd",
                                            solve_ift, args.iters, dev),
           "loss forward": timed("loss forward (outer_loss)",
                                 lambda: step.outer_loss(*outer_args),
                                 args.iters, dev),
           "outer pass": timed("outer pass (fwd + bwd)", outer, args.iters,
                               dev)}
    outer()                         # the gradients Adam applies
    for g in tr.optimizer.param_groups:
        g["lr"] = 1e-4
    out["adam"] = timed("Adam update", adam, args.iters, dev)
    out["backward"] = {k: (None if out["outer pass"][k] is None else
                           out["outer pass"][k] - out["loss forward"][k])
                       for k in ("wall_ms", "span_ms", "busy_ms")}
    b = out["backward"]
    print(f"  {'backward (pass - forward)':<34s} wall {b['wall_ms']:9.2f} "
          f"ms  span {fmt_ms(b['span_ms'])}  busy {fmt_ms(b['busy_ms'])}",
          flush=True)
    return out


if __name__ == "__main__":
    main()
