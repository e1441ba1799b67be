"""train_step_s: the window's wall seconds over the train_step calls it
completed, remeshes included; the window ends on a synchronize."""


def read(run):
    return run.window_s / len(run.steps) if run.steps else None
