"""The program's own spans and counters (``selfreconcode_tpu_torch.utils.
trace``) over a few steps after the traced ones, and what the per-layer
metrics that read them take from them.

``measure(session)`` runs once, whichever of those metrics' readers calls it
first: a step that would remesh is taken untraced first (the remesh has a
metric of its own), then each of the traffic's ``profile_steps`` steps runs
with the program's tracing on and is read (and cleared) after it, and
tracing is turned off again.  The records are left in
``session.extra["program_trace"]``, one per step.  The profiler's steps
(``trace.py``) come before these, with tracing off, so the launches and the
idle share they read are an untraced run's.

A span's duration is host time: the program adds no synchronize, so device
work still queued when a span ends is waited for in a later one (the
update's readback, at the latest).  A program without the tracing module
leaves nothing to read, and every reader then returns None."""
from __future__ import annotations

KEY = "program_trace"


def measure(session):
    if KEY in session.extra:
        return
    try:
        from selfreconcode_tpu_torch.utils import trace
    except ImportError:
        session.extra[KEY] = None
        return
    tr = session.trainer
    records = []
    while len(records) < int(session.cell.traffic["profile_steps"]):
        if tr.forward_time % tr.stage_cfg.remesh_intersect == 0:
            session.one_step()
            continue
        trace.read_and_clear()
        trace.enable()
        try:
            session.one_step()
        finally:
            trace.disable()
        records.append(trace.read_and_clear())
    session.extra[KEY] = records


def _records(run):
    return run.extra.get(KEY) or None


def span_ms(run, name: str):
    """Mean over the steps of the summed duration of the spans `name` in
    each, in ms; None where no step has one."""
    recs = _records(run)
    if recs is None or not any(s["name"] == name for r in recs
                               for s in r["spans"]):
        return None
    return 1e3 * sum(s["end"] - s["start"] for r in recs for s in r["spans"]
                     if s["name"] == name) / len(recs)


def counter_per_step(run, name: str):
    """The host counter `name` over the steps, per step; None where no step
    counted it."""
    recs = _records(run)
    if recs is None or not any(name in r["counters"] for r in recs):
        return None
    return sum(r["counters"].get(name, 0) for r in recs) / len(recs)


def solve_waste(row) -> float:
    """Share of a solve's iterations run after the last one that raised
    its converged count: row[0] is the count before the first iteration,
    row[i] after the i-th."""
    k = len(row) - 1
    last = max((i for i in range(1, k + 1) if row[i] > row[i - 1]),
               default=0)
    return (k - last) / k


def device_rows(run, name: str):
    """Every row of the device counter `name` over the steps; None where
    there is none."""
    recs = _records(run)
    rows = [row for r in recs or [] for row in r["device"].get(name, [])]
    return rows or None
