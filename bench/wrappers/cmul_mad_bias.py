"""``cmul_mad_bias``: the complex MAD with the (f',) float32 bias added
at the DC bin."""

import work
from devtrace import shape

MODULE = "cmul_mad.ops"


def work_of(args, kwargs, out):
    """(bytes, FLOPs) of one call."""
    return work.cmul_mad(shape(args[0]), shape(args[1]), bias=True)
