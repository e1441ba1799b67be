"""Run one cell of the benchmark once on the port (PyTorch + CUDA):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets up on the card, warms up the cell's shapes, drives the training loop
for --seconds, then checks the first steps against the plain reference
(``reference/``), and prints the result as the last line of standard
output (one JSON object) and the compared numbers beside their limits as
the last lines of standard error.  With --trace 0 the metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics (a few
steps at the end of the window under torch.profiler).  Fails, printing no
result, without a CUDA card or with fewer cards than the cell asks for,
and when JAX or the JAX package is loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os.path as osp  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@dataclass
class RunRecord:
    """What the metric readers read (``metrics/<metric>.py``).  The
    solver's iterations, the solver and the anchor are the configuration's
    algorithm as the reference runs it, not the program's settings."""
    config: dict
    setup_s: float
    window_s: float
    steps: List[dict]
    rays: int
    frames: int
    iters: int
    normal_loss: bool
    def_regu: bool
    newton: bool = True
    anchor_sub: int = 16384
    traced: list = field(default_factory=list)
    trace: Dict[str, object] = field(default_factory=dict)
    extra: Dict[str, float] = field(default_factory=dict)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def variant_numbers(cell, ref, base, r, s, states, mine, kw):
    """The compared numbers of the reference run with the keyword changes
    kw (TF32, or a planted fault) put in the program's place."""
    from benchmark.correctness import numbers
    from benchmark.session import ProgramSide
    c = ref.run(**{**base, **kw})
    side = ProgramSide(p0=c["p0"], g1=c["g1"], p3=c["p3"],
                       losses=c["losses"], skinner_ws=c["skinner_ws"])
    theirs = [c["template"]] + [
        ref.remesh_from(cell.config, st, s.device, tf32=kw.get("tf32", False))
        for st in states[1:]]
    return numbers(side, r, [(st, vc, fc, vr, fr) for st, (vc, fc), (vr, fr)
                             in zip(states, theirs, mine)],
                   miss=c["fit_miss"])


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None, tune=None, variants=None):
    """One run; returns (result dict, compared rows, {variant: numbers}).
    tune(session) runs after the set-up (tests plant faults there);
    variants maps a name to keyword changes of the reference run, which is
    then compared in the program's place (the control and the faults that
    calibrate.py reads)."""
    import torch
    from benchmark.cell import metric_module
    from benchmark.correctness import judge, numbers
    from benchmark.imports_check import loaded_violations
    from benchmark.reference import run as ref
    from benchmark.reference.step import SURF_ITERS, step_algorithm
    from benchmark.session import Session

    t0 = T0 if t0 is None else t0
    other = {}
    workdir = tempfile.mkdtemp(prefix="selfrecon-bench-")
    cuda = torch.device(device).type == "cuda"
    try:
        s = Session(cell, seed, workdir, device, t0=t0)
        s.set_up()
        if tune is not None:
            tune(s)
        s.warm_up()
        setup_s = time.perf_counter() - t0
        log("set-up seconds: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in s.phases.items()))
        s.window(seconds)
        t_win = time.perf_counter()
        stage = s.trainer.stage_cfg
        alg = step_algorithm(cell.config["conf"])
        rec = RunRecord(
            config=cell.config, setup_s=setup_s, window_s=s.window_s,
            steps=s.window_record, rays=stage.rays(), frames=stage.N,
            iters=SURF_ITERS,
            normal_loss=stage.has_normals and stage.weights.normal_weight > 0,
            def_regu=stage.weights.def_regu_weight > 0,
            newton=alg["surf_newton"], anchor_sub=alg["anchor_sub"],
            extra=s.extra)
        wanted = cell.per_layer if trace else cell.end_to_end
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                       "count": 1}
        if trace:
            from benchmark.trace import summary
            rec.traced, host_step = s.traced_steps(
                int(cell.traffic["profile_steps"]))
            rec.trace = summary(rec.traced, host_step)
            log(f"traced device seconds: splat kernels "
                f"{rec.trace['splat_device_s']!r}, mesh raster kernel "
                f"{rec.trace['raster_device_s']!r}")
            for m in wanted:
                measure = getattr(metric_module(m["name"]), "measure", None)
                if measure is not None:
                    measure(s)
            device_info.update(busy_s=rec.trace["busy_s"],
                               window_s=rec.trace["window_s"])
        device_info["memory_peak_bytes"] = (
            torch.cuda.max_memory_allocated() if cuda else 0)
        metrics = {}
        for m in wanted:
            v = metric_module(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        attempted = len(s.window_record)
        failed = sum(not r["finite"] for r in s.window_record)
        s.free()
        t_ref = time.perf_counter()

        base = dict(config=cell.config, stage_name=s.stage,
                    H=int(cell.traffic["H"]), W=int(cell.traffic["W"]),
                    body_path=s.body_path, scene=s.scene,
                    init_nets=s.init_nets, init_codes=s.init_codes, seed=seed,
                    fids=s.prog.fids, opt_times=s.opt_times0, lr=s.lr,
                    device=s.device, sdf_start=s.prog.sdf_fit())
        r = ref.run(**base)
        states = [s.setup_remesh] + s.prog.remeshes
        mine = [r["template"]] + [
            ref.remesh_from(cell.config, st, s.device) for st in s.prog.remeshes]
        values = numbers(s.prog, r, [(st, st["verts"], st["faces"], vr, fr)
                                     for st, (vr, fr) in zip(states, mine)])
        correct, rows = judge(values, cell.limits)
        correct = correct and failed == 0
        log(f"after the window: traced steps and metrics {t_ref - t_win:.2f}"
            f" s, reference and checks {time.perf_counter() - t_ref:.2f} s")
        from benchmark.correctness import worst_leaves
        other["worst_leaves"] = worst_leaves(s.prog, r)
        other["loss_gap_per_step"] = [abs(a - b) / abs(b) for a, b in
                                      zip(s.prog.losses, r["losses"])]
        other["misses"] = {k: r[k] for k in ("fit_miss", "start_miss",
                                             "unfit_miss")}
        if r["raster_ties"]:
            other["raster_ties"] = r["raster_ties"]
        log(f"diagnostics: {json.dumps(other)}")
        for name, kw in (variants or {}).items():
            other[name] = variant_numbers(cell, ref, base, r, s, states, mine,
                                          kw)
        bad = loaded_violations()
        if bad:
            raise RuntimeError(f"modules of JAX or the JAX package are "
                               f"loaded: {bad}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows, other


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.imports_check import static_violations
    bad = static_violations()
    if bad:
        log(f"the benchmark's sources import JAX or the JAX package: {bad}")
        return 2
    from benchmark.cell import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA devices, found "
            f"{torch.cuda.device_count()}")
        return 3
    result, rows, _ = run_cell(cell, args.seed, args.seconds,
                               bool(args.trace))
    for k, v, lim in rows:
        log(f"{k} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
