"""Roofline terms of a workload on a device profile (DESIGN.md §7).

  compute    = FLOPs_per_device / peak_FLOP/s
  memory     = bytes_per_device / HBM_bw
  collective = collective_bytes_per_device / link_bw

The port of ``RooflineTerms`` and ``roofline`` from
``repro.roofline.analysis``: the same arithmetic, so on the same profile
the terms equal the reference's.  Here ``hw`` defaults to the port's
target, ``H100_SXM``, and ``chips`` to one card.  The reference's
``collective_bytes`` and ``analyze_compiled`` read XLA's optimized HLO and
``compiled.cost_analysis()``; PyTorch has neither, so they have no
counterpart here: callers pass FLOPs and bytes counted from shapes, or
from ``count_step``, which runs a step on ``meta`` tensors and counts it.
"""

from __future__ import annotations

import weakref
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..core.hw import H100_SXM, HardwareSpec


@dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_flops_ratio: float = 0.0  # MODEL_FLOPS / (FLOPs * chips)

    def to_dict(self):
        return asdict(self)


def roofline(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    *,
    hw: HardwareSpec = H100_SXM,
    chips: int = 1,
    model_flops: float = 0.0,
) -> RooflineTerms:
    c = flops_per_device / hw.peak_flops
    m = bytes_per_device / hw.hbm_bw
    link = coll_bytes_per_device / hw.ici_bw
    dom = max(("compute", c), ("memory", m), ("collective", link), key=lambda t: t[1])[0]
    ratio = model_flops / (flops_per_device * chips) if flops_per_device else 0.0
    return RooflineTerms(
        flops_per_device, bytes_per_device, coll_bytes_per_device,
        c, m, link, dom, model_flops, ratio,
    )


# ---------------------------------------------------------------------------
# Step counting on meta tensors
# ---------------------------------------------------------------------------


@dataclass
class StepCounts:
    """What one step does, counted operator by operator (eager PyTorch).

    ``flops``: ``FlopCounterMode``'s count (matrix products, convolutions,
    attention; elementwise work is not counted, as XLA's cost analysis
    counts it only in fusions).  ``bytes_accessed``: the sum over every
    aten operator of its input and output bytes, the unfused traffic eager
    PyTorch moves, not XLA's fused count; an operator whose output aliases
    its input (a view) moves nothing, and an indexed read or in-place
    indexed write moves its indices and the rows it reads or writes, not
    its whole source or destination.
    ``arg_bytes``: the distinct storages of the arguments.  ``peak_bytes``:
    the arguments plus the most bytes of the storages the step created
    that were alive at once.  ``out_bytes``: the distinct storages of the
    output that the step created (an argument updated in place is not
    counted)."""

    flops: int
    bytes_accessed: int
    arg_bytes: int
    peak_bytes: int
    out_bytes: int

    def to_dict(self):
        return asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_aten = torch.ops.aten
# operators that read only the rows they index: the indices, and the rows
# read (the output's size) and written
_GATHERS = (_aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
            _aten.embedding.default)
# in-place indexed writes: the indices and values read, the values' rows written
_SCATTERS = (_aten.index_put_.default, _aten._index_put_impl_.default)


def _op_bytes(func, ins, outs) -> int:
    """Bytes an eager operator moves: its inputs read and outputs written."""
    if func in _GATHERS:
        return sum(_nbytes(t) for t in ins[1:]) + 2 * sum(_nbytes(t) for t in outs)
    if func in _SCATTERS:
        return sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
    if not func._schema.is_mutable:
        srcs = {t.untyped_storage()._cdata for t in ins}
        if func.is_view or any(t.untyped_storage()._cdata in srcs for t in outs):
            return 0
    return sum(_nbytes(t) for t in ins + outs)


class _ByteTracker(TorchDispatchMode):
    """Counts each operator's input and output bytes, and the live bytes of
    the storages created under it: a storage counts from the operator that
    creates it until its last tensor is freed (a finalizer on the storage)."""

    def __init__(self, args: Any):
        super().__init__()
        self.accessed = 0
        self.base = {}
        for t in pytree.tree_leaves(args):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.base[st._cdata] = st.nbytes()
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self.accessed += _op_bytes(func, ins, outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.base or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.current += st.nbytes()
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._free, key)
        return out


def count_step(fn: Callable, *args) -> StepCounts:
    """Run ``fn(*args)`` once (on ``meta`` tensors in the dry run: nothing
    is allocated) and count its FLOPs, bytes accessed and peak live bytes.
    Kernels launched by hand count on both routes: ``decode_attn`` through
    its operator's FLOP formula."""
    tracker = _ByteTracker(args)
    with FlopCounterMode(display=False) as flops, tracker:
        out = fn(*args)
    new = {}
    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in tracker.base:
                new[st._cdata] = st.nbytes()
    arg_bytes = sum(tracker.base.values())
    return StepCounts(int(flops.get_total_flops()), int(tracker.accessed), arg_bytes,
                      arg_bytes + tracker.peak, sum(new.values()))
