"""setup_s: seconds from the process's start to the end of the warm-up
(imports, inputs, skinner, SDF fit, kernel builds, the warm-up steps)."""


def read(run):
    return run.setup_s
