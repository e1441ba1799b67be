"""inner_ms: the inner pass's host time per step, in ms: the program's
``step.inner`` span (splat mask, IoU and mesh terms, their backward and the
binning's host syncs) over the steps run with the program's tracing on
(``program_trace.py``)."""
from benchmark.program_trace import measure, span_ms  # noqa: F401


def read(run):
    return span_ms(run, "step.inner")
