"""The share of the traced window in which no kernel or copy ran on the
device (the union of the trace's device intervals), in %."""

import devtrace


def read(run):
    return devtrace.idle_share(run)
