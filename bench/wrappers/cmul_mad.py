"""``cmul_mad``: the complex MAD over cached spectra, X (S, f, *bins) and
W (f', f, *bins) complex64."""

import work
from devtrace import shape

MODULE = "cmul_mad.ops"


def work_of(args, kwargs, out):
    """(bytes, FLOPs) of one call."""
    return work.cmul_mad(shape(args[0]), shape(args[1]))
