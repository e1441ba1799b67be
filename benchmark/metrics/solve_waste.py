"""solve_waste: the share of the surface solve's iterations run after the
last one that raised its converged ray count, in %, the mean over the
steps run with the program's tracing on (``program_trace.py``), read from
the program's ``solve_converged`` device counter."""
from benchmark.program_trace import (device_rows, measure,  # noqa: F401
                                     solve_waste)


def read(run):
    rows = [r for r in device_rows(run, "solve_converged") or []
            if len(r) > 1]
    if not rows:
        return None
    return 100.0 * sum(solve_waste(r) for r in rows) / len(rows)
