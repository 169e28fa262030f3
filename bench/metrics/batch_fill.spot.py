"""Patches run over (ticks x the executor's batch) in the window, in %."""


def read(run):
    if run.ticks <= 0:
        return None
    return 100.0 * run.patches / (run.ticks * run.batch)
