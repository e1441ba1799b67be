"""device_idle: the share of the traced steps' span in which the card runs
nothing, in %."""


def read(run):
    if not run.traced or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
