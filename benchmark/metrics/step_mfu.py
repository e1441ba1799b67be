"""step_mfu: the matrix-multiply FLOPs the window's steps need
(``flops.py``, counted from each step's shapes and the configuration's
solver and anchor) over the window's wall seconds at the card's float32
peak, in %."""
from benchmark.flops import net_macs, step_flops
from benchmark.peaks import PEAK_F32


def read(run):
    if not run.steps:
        return None
    macs = net_macs(run.config)
    flops = sum(step_flops(macs, run.rays, run.frames, s["nv"], run.iters,
                           run.normal_loss, run.def_regu, run.newton,
                           run.anchor_sub)
                for s in run.steps)
    return 100.0 * flops / (run.window_s * PEAK_F32)
