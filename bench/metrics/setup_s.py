"""Seconds from process start to the window's first request: imports, the
kernels' library, weights and volumes, the engine's prepared states and
the warm-up of every shape the window uses."""


def read(run):
    return run.setup_s
