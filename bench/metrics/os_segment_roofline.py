"""The fused overlap-save segment calls' least time (``work.os_segment``
from each call's shapes) over the device time of the kernels they
launched, in %."""

import devtrace


def read(run):
    return devtrace.roofline_share(run, ("os_segment_fused",))
