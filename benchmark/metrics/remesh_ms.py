"""remesh_ms: one warm Trainer.remesh(1.0) after the window, at the stage's
resolutions: the trainer's own synchronized timing."""


def measure(session):
    tr = session.trainer
    tr.remesh(1.0)
    session.extra["remesh_ms"] = 1e3 * tr.timings["remesh"]


def read(run):
    return run.extra.get("remesh_ms")
