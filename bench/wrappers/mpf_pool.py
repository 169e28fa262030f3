"""``mpf_pool``: max-pooling fragments, x (S, f, *n) float32 and the
pool size p."""

import work
from devtrace import shape

MODULE = "mpf_pool.ops"


def work_of(args, kwargs, out):
    """(bytes, FLOPs) of one call."""
    return work.mpf_pool(shape(args[0]), shape(out), int(args[1]))
