"""``os_segment_fused``: the overlap-save segment call from cached
spectra, F (N, Q, f, A, B, C'') and W (f', f, A, B, C''), with its bias
and cropped inverse (``os_segment_fused_tail`` goes through it)."""

import work
from devtrace import shape

MODULE = "os_segment.ops"


def work_of(args, kwargs, out):
    """(bytes, FLOPs) of one call."""
    F, W, b, spec = args[:4]
    return work.os_segment(shape(F), shape(W), shape(out), tuple(spec.fft_shape),
                           bias=b is not None)
