"""launches_per_step: device activities (kernels, copies, fills) in the
traced steps over their number."""


def read(run):
    if not run.traced:
        return None
    return run.trace["activities"] / len(run.traced)
