"""splat_roofline: the least time of the traced steps' splat forward and
backward launches (``splat_work.py``, from the splat centres, the radius
and the image) over the device time the splat kernels took, in %."""
from benchmark.splat_work import frame_work, least_time


def read(run):
    if not run.traced or run.trace["splat_device_s"] <= 0:
        return None
    least = 0.0
    for step in run.traced:
        for screen, r, H, W in step.splat_inputs:
            least += least_time(frame_work(screen[:, 0], screen[:, 1],
                                           screen[:, 2], r, H, W))
    return 100.0 * least / run.trace["splat_device_s"]
