"""The readings the limits of a cell are set from, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 \\
        [--seconds 20] [--control]

For each seed, one run of the cell (with a window of --seconds, which a
remesh check of the window needs) prints the compared numbers of the
program against the reference.  With --control the same run also reads,
in the program's place, the reference in TF32 (the control: the precision
below the configuration's float32 with TF32 off) and the reference with
half of each step's rays (a planted fault: half of the batch left out, the
mean taken over the rest).  A step that returns its state unchanged reads
change_gap = 1 by the measure's definition and needs no run.  One JSON
line per seed, with the leaves of the largest grad and change gaps and the
gap of each step's loss.
"""
import argparse
import json
import os.path as osp
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_variants(cell) -> dict:
    from benchmark.reference.step import stage_from_conf
    conf = cell.config["conf"]
    stage = stage_from_conf(conf, cell.traffic["stage"], 1, 1,
                            cell.config["resolutions"][cell.traffic["stage"]],
                            1, True)
    return {"tf32": {"tf32": True},
            "half_batch": {"rays_per_frame": stage.rays_per_frame // 2}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch
    from benchmark.cell import load_cell
    from benchmark.run import run_cell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    variants = control_variants(cell) if args.control else {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, rows, other = run_cell(cell, seed, args.seconds, False,
                                       t0=t0, variants=variants)
        line = {"workload": cell.name, "seed": seed,
                "correct": result["correct"],
                "program": {k: v for k, v, _ in rows}, **other,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
