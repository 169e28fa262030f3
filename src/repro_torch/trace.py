"""Named ranges around the served path's stages, on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function("znni." + name)`` while
a torch profiler is recording, and one shared do-nothing context
otherwise: there is no flag, environment variable or engine knob, and no
store of its own.  The ranges live in the profiler's timeline, beside the
CUDA kernels and copies they launch, so a ``torch.profiler`` chrome trace
(or its ``events()``) shows each stage of a serving tick on the same
clock as the device.  Off, a span costs one ``_profiler_enabled()`` check.

The spans (names without the ``znni.`` prefix) and where each opens:

``engine.submit``
    all of ``VolumeEngine.submit``: bucketing, padding, tiling, the
    output buffer.
``engine.step``
    all of ``VolumeEngine.step``, one tick; every span below runs inside
    it when the engine drives the executor.  A tick that runs a full and
    a strip group repeats the executor's spans once per group.
``engine.schedule``
    ranking, budget checks and popping the tick's patches.
``engine.extract``
    the dense walk's patches cut from the request's host volume.
``exec.begin_sweep``
    ``PlanExecutor.begin_sweep``: a new request's padded volume moved to
    the card (or pinned on the host when streaming).
``exec.resolve``
    ``_evict_left_of`` and the segment keys resolved against the sweep's
    cache: ``pattern``, ``parents``, ``misses`` (and the mixed tick's
    per-sweep eviction).
``exec.upload``
    host-to-device copies of inputs: the dense walk's patches
    (``_upload``, inside ``exec.walk``), a streaming sweep's slab.
``exec.segment_fft``
    ``slice_segment_spectra``: the missing layer-0 segment spectra.
``exec.assemble``
    ``_assemble_spectra``, the strip group's halos concatenated from the
    cache, and a mixed tick's spectra stack.
``exec.layer0``
    ``_layer0``: ``os_apply_tail_from_spectra`` (over all output columns
    on the full path) and the ReLU after it.
``exec.layer.<i>``
    deeper layer ``i`` (or the fused conv+pool pair starting at ``i``),
    its halo concatenation on the strip path and its ReLU.
``exec.recombine``
    ``recombine_fragments``: MPF fragments back into dense cores.
``exec.walk``
    the dense walk's ``CompiledPlan.apply``.
``exec.store``
    ``_store_spectra`` and ``_store_halos``: miss spectra and trailing
    activation halos filed for later patches.
``exec.copy_back``
    each ``.cpu().numpy()`` of a group's output; it waits for every
    kernel queued before it.
``exec.gather``
    ``np.stack`` of the groups' host outputs into the batch's array.
``engine.write_back``
    ``write_core``, ``finish_patch`` (strip finalization), ``end_sweep``
    and the tick's bookkeeping.

Read the host time a stage spends from its range on the host, and the
device time it causes from the kernels whose launch ran inside it
(matched by correlation id).
"""

from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "znni."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``znni.<name>`` profiler range while a profiler records, else a
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def spanned(name: str):
    """Decorate a function to run whole inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
