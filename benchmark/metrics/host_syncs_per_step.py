"""host_syncs_per_step: the program's ``host_syncs`` counter (each place a
step waits for the device to read a value on the host) over the steps run
with the program's tracing on (``program_trace.py``), per step."""
from benchmark.program_trace import counter_per_step, measure  # noqa: F401


def read(run):
    return counter_per_step(run, "host_syncs")
