"""solve_ms: the surface solve's host time per step, in ms: the program's
``step.outer.solve`` span (the Newton or Cauchy loop) over the steps run
with the program's tracing on (``program_trace.py``)."""
from benchmark.program_trace import measure, span_ms  # noqa: F401


def read(run):
    return span_ms(run, "step.outer.solve")
