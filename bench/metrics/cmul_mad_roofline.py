"""The complex MAD calls' least time (``work.cmul_mad`` from each call's
shapes), ``cmul_mad`` and ``cmul_mad_bias`` together, over the device time
of the kernels they launched, in %."""

import devtrace


def read(run):
    return devtrace.roofline_share(run, ("cmul_mad", "cmul_mad_bias"))
