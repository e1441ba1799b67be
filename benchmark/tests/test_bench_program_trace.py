"""The readers of the program's spans and counters (``program_trace.py``)
on made-up records, and their silence where the program recorded nothing
(a program without the tracing module)."""
import pytest

from benchmark.cell import metric_module
from benchmark.program_trace import KEY, measure, solve_waste


class Run:
    def __init__(self, records):
        self.extra = {KEY: records}


def span(name, start, end):
    return {"name": name, "start": start, "end": end}


def record(outer, solve, inner, syncs, rows):
    return {"spans": [span("step.outer.solve", 0.0, solve),
                      span("step.outer", 0.0, outer),
                      span("step.inner", 0.0, inner),
                      span("train_step", 0.0, 1.0)],
            "counters": {"host_syncs": syncs, "splat_fwd_launches": 1},
            "device": {"solve_converged": rows}}


RUN = Run([record(0.30, 0.20, 0.05, 428, [[10, 50, 60, 60, 60]]),
           record(0.40, 0.25, 0.07, 430, [[10, 20, 30, 40, 50]])])
WANT = {"outer_ms": 350.0, "solve_ms": 225.0, "inner_ms": 60.0,
        "host_syncs_per_step": 429.0,
        # first solve: last rise at iteration 2 of 4, so 2 of 4 wasted;
        # second: every iteration raised the count
        "solve_waste": 25.0}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_a_made_up_record(metric):
    assert metric_module(metric).read(RUN) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_is_silent_without_the_programs_records(metric):
    mod = metric_module(metric)
    assert mod.read(Run(None)) is None
    assert mod.read(Run([{"spans": [], "counters": {},
                          "device": {}}])) is None


def test_solve_waste_of_a_row():
    assert solve_waste([0, 0, 0]) == 1.0        # no iteration converged a ray
    assert solve_waste([3, 4, 4, 4]) == pytest.approx(2 / 3)
    assert solve_waste([3, 4, 5]) == 0.0


def test_measure_runs_once_and_leaves_a_missing_module_silent(monkeypatch):
    import builtins

    class Session:
        extra = {KEY: ["kept"]}

    measure(Session)                      # already measured: no step
    assert Session.extra[KEY] == ["kept"]
    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "selfreconcode_tpu_torch.utils" and "trace" in (
                fromlist or ()):
            raise ImportError("no tracing module")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    Session.extra = {}
    measure(Session)
    assert Session.extra == {KEY: None}
