"""Summarize an acceptance run's train log (port of the repository's
``tools/accept_report.py``, the same regexes and the same report).

Parses the train CLI's per-step ``X.XXs/it`` stamps and ``epoch N took
Xs`` lines (``cli/train.py::report``), splits them by stage at the stage
boundaries, and projects the whole schedule of the config (medium from
epoch 6, fine from epoch 12, nepoch 200: 201 epochs, at 450 frames) from
the measured per-stage rates.  A resumed run appends to the same log and
redoes part of an epoch: the last sample of each (epoch, step) wins.

    python -m selfreconcode_tpu_torch.tools.accept_report DATA_ROOT \\
        [--epochs-total 200] [--medium 6] [--fine 12] [--frames 450]

``parse_log``, ``stage_rates`` and ``project`` are separate so that a
shortened run (``acceptance_run``: its own frames and stage epochs) is
measured on its own schedule and projected onto the config's.  Host tool;
--device only refuses to run without the card, as every tool of the port
does (``--device cpu`` for tests).
"""
from __future__ import annotations

import argparse
import os.path as osp
import re
import sys

import numpy as np

STEP_RE = re.compile(r"([0-9.]+)s/it")
EPOCH_RE = re.compile(r"\((\d+)/(\d+)\): loss")
EPOCH_TOOK_RE = re.compile(r"epoch (\d+) took ([0-9.]+)s")
STAGES = ("coarse", "medium", "fine")
BATCH = {"coarse": 3, "medium": 2, "fine": 1}   # config.conf's batch sizes


def parse_log(path: str):
    """-> (steps, epochs): steps = [(epoch, s_per_it), ...] in (epoch,
    step) order, the last sample of each (epoch, step) winning, and epochs
    = {epoch: wall s} (the last line of each epoch winning)."""
    samples = {}
    epochs = {}
    epoch, di = 0, -1
    with open(path) as f:
        for line in f:
            m = EPOCH_RE.search(line)
            if m:
                epoch, di = int(m.group(1)), int(m.group(2))
            m = EPOCH_TOOK_RE.search(line)
            if m:
                epochs[int(m.group(1))] = float(m.group(2))
                continue
            m = STEP_RE.search(line)
            if m:
                samples[(epoch, di)] = float(m.group(1))
    return [(e, s) for (e, _), s in sorted(samples.items())], epochs


def stage_of(epoch: int, medium: int, fine: int) -> str:
    if epoch < medium:
        return "coarse"
    if epoch < fine:
        return "medium"
    return "fine"


def steps_per_epoch(frames: int) -> dict:
    """Floor division: the batch iterator drops a short last group
    (``data/dataset.py::batch_iterator``)."""
    return {k: frames // b for k, b in BATCH.items()}


def stage_rates(samples, epoch_wall, medium: int, fine: int,
                frames: int) -> dict:
    """Per stage of a run of `frames` frames whose medium and fine stages
    start at these epochs: {stage: {"epochs", "rate" (s/step from the
    median epoch, None when the stage did not run), "one_time" (s above
    the steady rate in epochs > 1.5x the median), "rejit_epochs",
    "dt" (the step stamps), "epoch_s" ([(epoch, s), ...])}}."""
    spe = steps_per_epoch(frames)
    out = {}
    for st in STAGES:
        xs = np.array([s for ep, s in samples
                       if stage_of(ep, medium, fine) == st])
        ew = [(ep, s) for ep, s in sorted(epoch_wall.items())
              if stage_of(ep, medium, fine) == st]
        r = {"epochs": len(ew), "rate": None, "one_time": 0.0,
             "rejit_epochs": 0, "dt": xs, "epoch_s": ew}
        if ew:
            # the median epoch is the steady rate; only clear outliers
            # (> 1.5x) count as one-time cost, not ordinary variance
            walls = np.array([s for _, s in ew])
            steady_epoch = float(np.median(walls))
            rejit = walls[walls > 1.5 * steady_epoch]
            r.update(rate=steady_epoch / spe[st],
                     one_time=float((rejit - steady_epoch).sum()),
                     rejit_epochs=int(rejit.size))
        out[st] = r
    return out


def schedule_steps(frames: int, medium: int, fine: int,
                   epochs_total: int) -> dict:
    """{stage: (epochs, steps per epoch)} of a schedule; the train loop
    runs range(start, nepoch + 1), nepoch + 1 epochs in all."""
    spe = steps_per_epoch(frames)
    n_epochs = {"coarse": medium, "medium": fine - medium,
                "fine": epochs_total + 1 - fine}
    return {st: (n_epochs[st], spe[st]) for st in STAGES}


def project(rates: dict, frames: int, medium: int, fine: int,
            epochs_total: int) -> float:
    """Seconds of the whole schedule at the measured rates, one-time costs
    added once; nan when a stage has no rate."""
    total_s = 0.0
    for st, (n_ep, spe) in schedule_steps(frames, medium, fine,
                                          epochs_total).items():
        if rates[st]["rate"] is None:
            return float("nan")
        total_s += n_ep * spe * rates[st]["rate"] + rates[st]["one_time"]
    return total_s


def print_report(rates: dict, frames: int, medium: int, fine: int,
                 epochs_total: int) -> float:
    """The report's table and projection lines; returns the projection."""
    spe = steps_per_epoch(frames)
    sched = schedule_steps(frames, medium, fine, epochs_total)
    print(f"{'stage':8s} {'epochs':>7s} {'wall s/step':>12s} "
          f"{'dt-mean':>8s} {'dt-med':>8s}  notes")
    for st in STAGES:
        r = rates[st]
        xs = r["dt"]
        if r["rate"] is not None:
            dts = (f"{xs.mean():8.3f} {np.median(xs):8.3f}" if xs.size
                   else f"{'--':>8s} {'--':>8s}")
            print(f"{st:8s} {r['epochs']:7d} {r['rate']:12.3f} {dts}  "
                  f"{spe[st]} steps/epoch, one-time (compile) "
                  f"~{r['one_time']:.0f}s over {r['rejit_epochs']} epochs")
        else:
            print(f"{st:8s} {0:7d} {'--':>12s} {'--':>8s} {'--':>8s}  "
                  "NOT MEASURED (schedule truncated before this stage)")
    total_s = project(rates, frames, medium, fine, epochs_total)
    print(f"\nfull {epochs_total + 1}-epoch schedule at measured rates: "
          f"{total_s / 3600.0:.2f} h "
          f"({sched['coarse'][0]}x{sched['coarse'][1]} + "
          f"{sched['medium'][0]}x{sched['medium'][1]} + "
          f"{sched['fine'][0]}x{sched['fine'][1]} steps)")
    return total_s


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--epochs-total", type=int, default=200)
    ap.add_argument("--medium", type=int, default=6)
    ap.add_argument("--fine", type=int, default=12)
    ap.add_argument("--frames", type=int, default=450)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..cli.train import open_device
    a = parse_args(argv)
    open_device(a.device)
    log = osp.join(a.root, "train.log")
    samples, epoch_wall = parse_log(log)
    if not samples:
        print("no s/it samples found in", log)
        return 1
    rates = stage_rates(samples, epoch_wall, a.medium, a.fine, a.frames)
    print_report(rates, a.frames, a.medium, a.fine, a.epochs_total)
    err = osp.join(a.root, "rec", "errors.txt")
    if osp.exists(err):
        with open(err) as f:
            lines = f.read().strip().splitlines()
        print("\nerrors.txt:", lines[-1] if lines else "(empty)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
