"""Hand-written Hopper (sm_90a) CUDA kernels for the port's hot spots.

Each kernel is a subpackage with ops.py (the wrapper: checks, allocation,
launch on PyTorch's current stream, a launch counter) and ref.py (its
plain PyTorch version, which the CPU tests and the on-card comparisons
use).  ``launch_counts``/``reset_launch_counts`` read and zero the
wrappers' counters.  Sources live in ``csrc/`` and are built by ``build.library()`` at
first use.  Dispatch rule: ``dispatch.resolve_use_kernels``.
"""

from typing import Dict

from . import cmul_mad, mpf_pool, os_segment  # noqa: F401
from .dispatch import resolve_device, resolve_use_kernels  # noqa: F401

_COUNTERS = (os_segment.ops.launches, cmul_mad.ops.launches, mpf_pool.ops.launches)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel wrapper since the last reset."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0
