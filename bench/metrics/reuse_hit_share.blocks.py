"""Layer-0 segment spectra served from the sweep's cache over all segment
lookups in the window (the executor's hit and miss counters), in %."""


def read(run):
    n = run.os_hits + run.os_misses
    if n <= 0:
        return None
    return 100.0 * run.os_hits / n
