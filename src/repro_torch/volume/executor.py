"""Plan-driven patch executor: run a planner ``Plan`` over a whole volume.

``PlanExecutor`` compiles a plan (per-layer primitives + patch geometry)
into a ``primitives.CompiledPlan`` — cached kernel spectra for
``fft_cached`` and ``overlap_save`` layers, per-layer pruned-FFT shapes,
pool modes — and sweeps a volume patch by patch.  Patch-geometry
invariants (see ``tiler``): every patch spans ``extent = core + FOV - 1``
input voxels and contributes a ``core³`` dense block; adjacent patches
overlap by FOV-1 input voxels; edge patches are *shifted*; the patch
stream is x-major with non-decreasing x.

Two kinds of plan run here.

Dense walk — plans whose first conv is not ``overlap_save``, and plans
with plain pools: ``run_patch_batch(xs)`` runs ``CompiledPlan.apply`` over
a stacked batch of raw patches; with ``fuse_pairs`` (on with the kernels)
each ``fft_cached``+``mpf`` pair runs as one fused call.  MPF plans emit
each patch's ``core³`` block in one walk (fragments recombined);
plain-pool plans sweep the P³ shifted subsamplings of each patch (the
paper's naive outer loop) and interleave them into the core.

Overlap-save reuse — the FIRST conv is ``overlap_save`` with its segment
grid pinned to the patch core, and the pools are ``mpf``:

* Layer-0 spectra reuse: within one sweep (``begin_sweep``/``end_sweep``)
  segment spectra are cached by ``tiler.segment_keys``, so the FOV overlap
  a neighbour shares is transformed once.  ``os_seg_fft`` counts segment
  FFTs run, ``os_seg_hits`` segments served from the cache.
* Deep activation reuse (``deep_reuse``): every patch stores, per layer
  l >= 1, the trailing ``size_l - 1`` x-columns of that layer's input,
  keyed by its x-successor's start.  An interior patch then runs the STRIP
  path: layer 0 pays MAD + inverse only for the ``tail_segments`` of its
  new core columns, each deeper layer runs on cached halo + new strip.
  Counters ``os_mad_segments``, ``deep_strip_patches``,
  ``deep_full_patches``; ``predict_counts`` predicts them exactly.
* ``fuse_os`` routes eligible ``fft_cached``+``mpf`` pairs of the capture
  and strip walks through ``fft_conv_pool_fused_halo``; off the kernel
  path output is bitwise equal to the unfused walks.  ``fused_pair_calls``
  counts them; ``os_fused_segments`` is the number of segments the
  os_segment CUDA kernel computed during ``run``, read off its wrapper's
  counter (equal to ``os_mad_segments`` on the card, else 0).

Host-staged streaming (``ram_budget``/``streaming``, reuse plans): the
padded volume stays in pinned HOST memory and never enters the ledger.
Chunks are capped at x-plane boundaries (``tiler.chunk_patches``), so each
chunk reads one constant-shape input x-slab ``[x0, x0 + span)``; ``_slab``
copies it to the card on a side CUDA stream (``core.staging``), and
``_run_batched`` stages the next plane's slab while the current chunk
runs.  The eviction sweep (``_evict_left_of``) frees spectra, halos and
slabs the stream moved past.  The walks are the dense mode's — only the
volume operand and the slab-relative miss starts change — so streamed
output is bitwise equal to dense.

Split strategies (``pipeline2``/``hetero`` plans) walk raw patches through
layers [0, θ) and [θ, L) as two stages.  ``pipeline2`` runs the
queue-depth-1 loop ``core.pipeline.pipelined_apply``: in one process, or,
with a ``torch.distributed`` default group initialized, as a ring over its
ranks, each running its share of the chunks (the reference's pod axis);
``hetero`` places each stage on the device class of the profile it was
priced on (``pipeline.hetero_stage_devices``: a host-CPU profile's stage
runs on the CPU with the plain versions, the other on the executor's
device with the kernels) and hands the split activation over through
pinned host memory, counting its bytes.

Every mode keeps a ``_DeviceLedger`` of the executor-managed device
buffers; ``last_stats["peak_device_bytes"]`` reports its per-sweep peak,
which ``predict_memory`` reproduces for reuse plans.

PyTorch runs eagerly, so nothing is traced; the executor still records
the distinct step keys the reference's jit would specialize on, so
``last_stats["retraces"]`` keeps its meaning.

Any sweep axis (``sweep_axis``, per executor or per run): every sweep
coordinate lives in the tiler's working frame, and the conv weights are
permuted into it (``_permute_conv_params``).  States belong to an axis,
not to a scope: the executor's own axis is compiled up front, any other
axis lazily on its first scope (``_states_for_axis``), and scopes on one
axis share them.  A serving tick that mixes axes walks one stack per
axis (``_run_os_batch_mixed``).

Shard boundaries of the sharded fleet: ``export_handoff`` stages a
scope's cache entries at or past a plane to host tensors (a
``distributed.collectives.HaloPackage``), ``import_handoff`` files them
into another scope, and ``handoff_entry_nbytes`` sizes one entry of each
kind for the fleet's exact byte prediction.

Per-hardware tuned configs (``repro_torch.tuning``): ``tuned="auto"``
loads the persisted winner for (the executor's device kind, ``net.name``)
if one exists; a ``TunedConfig`` is taken as given.  It fills only knobs
the caller left unset: ``fuse_pairs``, ``fprime_chunk`` and ``fuse_os``,
and m and batch only on a plan-less build (with a Plan they are part of
the planner's costed geometry).  ``tuned_provenance`` reports it.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs.base import ConvNetConfig
from ..core import overlap_save as os_mod
from ..core.fft_conv import fft_conv_pool_fused_halo
from ..core.mpf import recombine_fragments
from ..core.pipeline import hetero_stage_devices, make_stage_fns, pipelined_apply
from ..core.planner import Plan
from ..core.primitives import (
    CompiledPlan,
    PreparedLayer,
    apply_prepared_range,
    compile_plan,
    conv_primitive,
    fused_pairs,
    plan_input_size,
    pool_primitive,
    resolve_primitive,
)
from ..core.staging import HostStager, pin
from ..distributed.host_group import all_gather_cat, group_rank, group_size
from ..kernels.dispatch import DeviceLike, resolve_device, resolve_use_kernels
from ..kernels.os_segment import ops as _seg_ops
from ..trace import span, spanned
from ..tuning.store import TunedConfig, load_tuned_config
from .tiler import (
    HaloSpec,
    SweepCounts,
    VolumeTiling,
    chunk_patches,
    extract_patch,
    pad_volume,
    predict_sweep_counts,
    sweep_perm,
    tile_volume,
)


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _permute_conv_params(params, net: ConvNetConfig, perm: Tuple[int, int, int]):
    """Permute conv kernels into the working frame of a sweep axis.

    Valid correlation commutes with a joint permutation of data and kernel
    spatial axes, so permuting every conv weight by the volume's spatial
    permutation makes the compiled stack axis-generic.  Identity perm
    returns ``params`` unchanged (same objects).
    """
    if perm == (0, 1, 2):
        return params
    axes = (0, 1, 2 + perm[0], 2 + perm[1], 2 + perm[2])
    out = []
    for p, layer in zip(params, net.layers):
        if layer.kind == "conv" and p is not None:
            w, b = p
            out.append((w.permute(axes).contiguous(), b))
        else:
            out.append(p)
    return out


class _PendingMiss(NamedTuple):
    """Sweep-cache placeholder: this key's spectrum is being computed in
    the current batch as miss row ``idx`` (dedups within-batch repeats)."""

    idx: int


class _SpectrumRef(NamedTuple):
    """Sweep-cache entry: row ``idx`` of a stored miss-FFT output tensor.

    Parents are split by absolute segment x at storage time (all rows of
    one parent share one x), so the per-key eviction sweep actually frees
    device memory.
    """

    parent: Any  # (M, f, ña, ñb, ñc) tensor; one absolute x per parent
    idx: int


class _DeviceLedger:
    """Accounting of the executor-managed device working set (bytes).

    ``current`` tracks buffers the executor holds across steps (prepared
    states, staged slabs, cached segment spectra, activation halos, a
    non-streaming sweep's resident volume); ``transient`` samples a step's
    in-flight extras on top of ``current``.  ``peak`` is
    ``last_stats["peak_device_bytes"]``, which the planner's
    ``predict_stream_peak`` simulation reproduces.
    """

    def __init__(self) -> None:
        self.current = 0.0
        self.peak = 0.0

    def alloc(self, nbytes: float) -> None:
        self.current += nbytes
        if self.current > self.peak:
            self.peak = self.current

    def free(self, nbytes: float) -> None:
        self.current = max(0.0, self.current - nbytes)

    def transient(self, nbytes: float) -> None:
        """A step's extra in-flight bytes: bumps peak, not current."""
        if self.current + nbytes > self.peak:
            self.peak = self.current + nbytes

    def begin_run(self) -> None:
        """Scope the peak to one sweep (states/caches carry over)."""
        self.peak = self.current


def _tree_nbytes(*trees) -> float:
    """Total bytes of the distinct tensors in nested lists/tuples/dicts."""
    seen: Dict[int, float] = {}

    def visit(node):
        if isinstance(node, torch.Tensor):
            seen[id(node)] = _nbytes(node)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(trees)
    return sum(seen.values())


def _states_to(states, device: torch.device):
    """A copy of prepared state dicts with every tensor on ``device``."""
    return [
        {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in st.items()}
        for st in states
    ]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PlanExecutor:
    """Bind a Plan (or explicit prims + fragment size) to a volume sweep."""

    def __init__(
        self,
        params,
        net: ConvNetConfig,
        plan: Optional[Plan] = None,
        *,
        prims: Optional[Sequence[str]] = None,
        m: Optional[int] = None,
        batch: Optional[int] = None,
        theta: int = -1,
        use_kernels: Optional[bool] = None,
        fuse_pairs: Optional[bool] = None,
        fprime_chunk=None,
        fuse_os: Optional[bool] = None,
        tuned: Union[str, TunedConfig, None] = "auto",
        deep_reuse: bool = True,
        ram_budget: Optional[float] = None,
        streaming: Optional[bool] = None,
        sweep_axis: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        # per-hardware tuned config: ``"auto"`` loads the persisted winner
        # for (this executor's device kind, net.name) if one exists.  It
        # fills only knobs the caller left unset, and m/batch only on a
        # plan-less build: with a Plan they are the planner's costed
        # geometry (predicted == measured counters).
        self.tuned: Optional[TunedConfig] = (
            load_tuned_config(net.name, device=self.device) if tuned == "auto"
            else (tuned if isinstance(tuned, TunedConfig) else None)
        )
        if self.tuned is not None:
            if fuse_pairs is None:
                fuse_pairs = self.tuned.fuse_pairs
            if fprime_chunk is None:
                fprime_chunk = self.tuned.fprime_chunk
            if fuse_os is None:
                fuse_os = self.tuned.fuse_os
            if plan is None and prims is not None:
                m = m if m is not None else self.tuned.m
                batch = batch if batch is not None else self.tuned.batch
        if sweep_axis is None:
            sweep_axis = getattr(plan, "sweep_axis", 0) if plan is not None else 0
        self.sweep_axis = int(sweep_axis)
        params = [
            None if p is None else (p[0].to(self.device), p[1].to(self.device))
            for p in params
        ]
        # the volume-frame params: every other axis's states permute them
        self._orig_params = params
        self.params = _permute_conv_params(params, net, sweep_perm(self.sweep_axis))
        self.net = net
        self.plan = plan
        if plan is not None:
            prims = plan.prims
            m = plan.m_final
            batch = batch or plan.batch
            theta = plan.theta if plan.strategy in ("pipeline2", "hetero") else -1
            if ram_budget is None:
                ram_budget = plan.ram_budget
        # hetero plans run the split on two devices, each stage where its
        # profile says (see run/_run_hetero)
        self.hetero = plan is not None and plan.strategy == "hetero"
        self.stage_devices = (
            hetero_stage_devices(plan.devices, self.device) if self.hetero else None
        )
        if prims is None or m is None:
            raise ValueError("need either a Plan or explicit prims + m")
        # a plan solved under a RAM budget runs host-staged; ``streaming``
        # can force either mode
        self.ram_budget = ram_budget
        self.streaming = (
            bool(streaming) if streaming is not None else ram_budget is not None
        )
        self.prims = tuple(prims)
        self.m = m
        self.batch = max(1, batch or 1)
        self.theta = theta
        # the caller's tri-state goes to every wrapper; the resolved value
        # says whether this executor's data runs through the CUDA kernels
        self._use_kernels = use_kernels
        self.use_kernels = resolve_use_kernels(use_kernels, self.device)

        self.P = net.total_pooling()
        self.fov = net.field_of_view()
        self.core = m * self.P
        self.uses_mpf = "mpf" in self.prims
        self.n_in = self._n_in()
        self.extent = self.n_in if self.uses_mpf else self.n_in + self.P - 1
        if self.extent != self.core + self.fov - 1:
            raise AssertionError((self.extent, self.core, self.fov))
        self.out_channels = [l for l in net.layers if l.kind == "conv"][-1].out_channels

        self._fprime_chunk = fprime_chunk
        self.compiled: CompiledPlan = self._compile(self.params, fuse_pairs)
        self.fuse_pairs = self.compiled.fuse_pairs
        self._seen_batch_sizes: set = set()
        self.last_stats: Dict[str, float] = {}

        # -- overlap-save input-spectra reuse state --------------------------
        self._os_reuse = self.prims[0] == "overlap_save" and self.uses_mpf
        self._sweeps: Dict[int, Dict[Tuple[int, int, int], Any]] = {}
        self._sweep_vols: Dict[int, torch.Tensor] = {}  # non-streaming scopes
        self._sweep_hosts: Dict[int, torch.Tensor] = {}  # streaming scopes
        # staged slabs per scope: x0 -> (device slab, its copy's ready event)
        self._sweep_slabs: Dict[int, Dict[int, Tuple[torch.Tensor, Any]]] = {}
        self._stager = HostStager(self.device) if self.streaming else None
        self._hetero_states = None
        self._hetero_stats: Dict[str, float] = {}
        self._key_bytes: Dict[Tuple[int, Tuple[int, int, int]], float] = {}
        self._sweep_counter = 0
        self._os_misses = 0
        self._os_hits = 0
        self._os_mad_segments = 0
        self._deep_strips = 0
        self._deep_fulls = 0
        self._fused_pair_calls = 0
        self._last_conv = max(i for i, l in enumerate(net.layers) if l.kind == "conv")
        # the conv+pool pairs the halo-emitting fused epilogue serves below
        # the input (layer 0 is walked apart)
        self._fused_pairs: Tuple[int, ...] = tuple(
            i for i in fused_pairs(net, self.compiled.layers) if i >= 1
        )
        self.fuse_os = bool(fuse_os) and bool(self._fused_pairs) and self._os_reuse
        self._trace_keys: set = set()  # distinct step keys seen
        self.deep_reuse = bool(self._os_reuse and deep_reuse)
        self._halo_caches: Dict[int, Dict[Tuple[int, int, int], List]] = {}
        if self._os_reuse:
            spec0 = self.compiled.layers[0].os_spec
            self.halo = HaloSpec(spec0.seg_core, spec0.seg_extent, spec0.starts)
        else:
            self.halo = None
        if self.deep_reuse:
            spec0 = self.compiled.layers[0].os_spec
            self._q_strip = os_mod.tail_segments(spec0, self.core)
            self._strip_layers, self._strip_info = self._build_strip_plan()
            self._strip_states = [
                pl.state if pl is not None else None for pl in self._strip_layers
            ]
        else:
            self._q_strip = None
        # every scope records its axis; the axis's prepared states are
        # built once (the executor's own axis here, others lazily)
        self._sweep_axes: Dict[int, int] = {}
        self._axis_states: Dict[int, Tuple[Any, Any]] = {
            self.sweep_axis: (
                self.compiled.states, getattr(self, "_strip_states", None)
            )
        }
        # prepared states (weights, cached kernel spectra at full AND strip
        # shapes) are resident for the executor's lifetime
        self._ledger = _DeviceLedger()
        strip_states = getattr(self, "_strip_states", [])
        self._ledger.alloc(_tree_nbytes(self.params, self.compiled.states, strip_states))
        self._predict_memory_cache: Dict[Tuple[int, int, int, int], Any] = {}

    def tuned_provenance(self) -> Optional[Dict[str, Any]]:
        """The tuned config this executor runs under (``TunedConfig.
        provenance``), ``None`` when untuned."""
        return None if self.tuned is None else self.tuned.provenance()

    # -- geometry ------------------------------------------------------------

    def _n_in(self) -> int:
        """Input size per apply call, from the net walked backwards."""
        return plan_input_size(self.net, self.prims, self.m)

    def tiling_for(
        self, vol_shape: Sequence[int], *, sweep_axis: Optional[int] = None
    ) -> VolumeTiling:
        return tile_volume(
            vol_shape, core=self.core, fov=self.fov, halo=self.halo,
            sweep_axis=self.sweep_axis if sweep_axis is None else int(sweep_axis),
        )

    def bucket_shape(self, vol_shape: Sequence[int]) -> Tuple[int, int, int]:
        """Round a volume shape up to the executor's patch-grid bucket.

        Axes are padded so the dense output is a whole number of cores:
        arbitrary request shapes collapse onto a few buckets and every
        patch start is core-aligned.  Exact by the pad-and-crop argument.
        Raises for axes below the FOV.
        """
        for ax, x in enumerate(vol_shape):
            if x < self.fov:
                raise ValueError(
                    f"axis {ax} extent {x} < FOV {self.fov}: no valid output exists"
                )
        return tuple(
            math.ceil((x - self.fov + 1) / self.core) * self.core
            + self.fov - 1
            for x in vol_shape
        )

    def predict_counts(
        self, vol_shape: Sequence[int], *, batch: Optional[int] = None,
        sweep_axis: Optional[int] = None,
    ) -> SweepCounts:
        """Planner-side prediction of this executor's sweep counters; equal
        to the measured ``last_stats`` counters 1:1."""
        if not self._os_reuse:
            raise ValueError("predict_counts needs an overlap-save reuse plan")
        tiling = self.tiling_for(vol_shape, sweep_axis=sweep_axis)
        return predict_sweep_counts(
            tiling, batch=batch or self.batch,
            deep_reuse=self.deep_reuse, strip_segments=self._q_strip,
        )

    def _compile(self, params, fuse_pairs) -> CompiledPlan:
        """``compile_plan`` of this executor's plan over ``params`` (one
        axis's working-frame weights)."""
        return compile_plan(
            params, self.net, prims=self.prims, n_in=self.n_in,
            use_kernels=self._use_kernels, fuse_pairs=fuse_pairs,
            fprime_chunk=self._fprime_chunk, plan=self.plan,
            overlap_seg=self.core if self.prims[0] == "overlap_save" else None,
        )

    def _states_for_axis(self, axis: int):
        """Prepared state lists ``(states, strip_states)`` for one axis.

        Patches and kernels are cubic, so every working frame has the same
        shapes and shares the layer metadata; only the numbers differ: the
        weights permuted into that axis's frame and their cached kernel
        spectra.  Another axis's states are built on first use through the
        same ``_compile`` and strip setup as the executor's own, and
        ledgered like them.
        """
        got = self._axis_states.get(axis)
        if got is None:
            p_ax = _permute_conv_params(self._orig_params, self.net, sweep_perm(axis))
            compiled = self._compile(p_ax, self.fuse_pairs)
            strip_states = None
            if self.deep_reuse:
                layers, _ = self._build_strip_plan(p_ax)
                strip_states = [pl.state if pl is not None else None for pl in layers]
            got = (compiled.states, strip_states)
            self._axis_states[axis] = got
            self._ledger.alloc(_tree_nbytes(got[0], strip_states or []))
        return got

    def _build_strip_plan(self, params=None):
        """One-time setup of the interior-patch strip walk (layers >= 1).

        Binds each layer below the input to the strip extent an interior
        patch runs: ``new_x + size - 1`` sweep-axis columns at the full
        walk's cross extents.  Returns ``(layers, info)`` with
        ``info[i] = (halo columns, fragment batch multiplier)``.
        ``params`` defaults to the executor's working-frame params; another
        axis's permuted params build that axis's strip states.
        """
        if params is None:
            params = self.params
        n = self.n_in
        P_cur, frag = 1, 1
        layers: List[Optional[PreparedLayer]] = [None] * len(self.net.layers)
        info: List[Optional[Tuple[int, int]]] = [None] * len(self.net.layers)
        for i, layer in enumerate(self.net.layers):
            if i > 0:
                new_x = self.core // P_cur
                h = layer.size - 1
                w_in = new_x + h
                if w_in > n:
                    raise AssertionError((i, w_in, n))
                if layer.kind == "conv":
                    w, b = params[i]
                    layers[i] = conv_primitive(self.prims[i]).setup(
                        w, b, (w_in, n, n), index=i
                    )
                else:
                    layers[i] = pool_primitive(self.prims[i]).setup(
                        layer.size, (w_in, n, n), index=i
                    )
                info[i] = (h, frag)
            if layer.kind == "conv":
                n = n - layer.size + 1
            else:
                n = n // layer.size
                P_cur *= layer.size
                frag *= layer.size**3
        return tuple(layers), tuple(info)

    def _record_trace(self, key: Tuple) -> None:
        """Track distinct step keys (last_stats["retraces"])."""
        self._trace_keys.add(key)

    # -- overlap-save sweep cache -------------------------------------------

    @spanned("exec.begin_sweep")
    def begin_sweep(
        self, padded: np.ndarray, *, sweep_axis: Optional[int] = None
    ) -> int:
        """Open a fresh spectra-reuse scope (one volume sweep / request).

        Segment keys are absolute coordinates within one padded volume
        swept on one axis, so spectra never leak across requests, and
        scopes on different axes batch in one tick without key collisions.
        ``padded`` must already be in ``sweep_axis``'s working frame (the
        default is the executor's axis).  The volume is extended along
        working axis 0 so the aligned grid's tail segments stay in bounds,
        then either uploaded to the device once (dense mode) or kept in
        pinned host memory (streaming mode), from which ``_slab`` stages
        one slab per plane: peak device bytes then scale with the slab,
        not the volume.
        """
        axis = self.sweep_axis if sweep_axis is None else int(sweep_axis)
        spec0 = self.compiled.layers[0].os_spec
        max_x0 = max(0, padded.shape[1] - self.extent)
        short = max(0, max_x0 + spec0.span - padded.shape[1])
        self._sweep_counter += 1
        token = self._sweep_counter
        self._sweeps[token] = {}
        self._sweep_axes[token] = axis
        if self.streaming:
            host = np.asarray(padded, np.float32)
            if short:
                host = np.pad(host, ((0, 0), (0, short), (0, 0), (0, 0)))
            self._sweep_hosts[token] = pin(host, self.device)
            self._sweep_slabs[token] = {}
            return token
        vol = torch.as_tensor(np.asarray(padded, np.float32), device=self.device)
        if short:
            vol = torch.nn.functional.pad(vol, (0, 0, 0, 0, 0, short))
        self._sweep_vols[token] = vol
        self._ledger.alloc(_nbytes(vol))
        return token

    def end_sweep(self, token: Optional[int]) -> None:
        self._sweep_axes.pop(token, None)
        vol = self._sweep_vols.pop(token, None)
        if vol is not None:
            self._ledger.free(_nbytes(vol))
        self._sweep_hosts.pop(token, None)
        for slab, _ in self._sweep_slabs.pop(token, {}).values():
            self._ledger.free(_nbytes(slab))
        for key in self._sweeps.pop(token, {}):
            self._ledger.free(self._key_bytes.pop((token, key), 0.0))
        for entry in self._halo_caches.pop(token, {}).values():
            self._ledger.free(sum(_nbytes(h) for h in entry))

    # -- host-staged streaming slabs ----------------------------------------

    def _slab(self, token: int, x0: int) -> Tuple[torch.Tensor, Any]:
        """Stage the input x-slab ``[x0, x0 + span)`` of a streaming sweep.

        Every chunk of a plane reads the same constant-shape slab (the
        plane cap of ``tiler.chunk_patches`` guarantees it).  The copy runs
        on the stager's side stream; returns ``(slab, ready)``, and a
        reader makes the compute stream wait on ``ready`` before its first
        read (``_stager.wait``).  Already-staged slabs are returned as they
        are, so ``_run_batched`` can stage the next plane's slab while the
        current chunk runs.
        """
        slabs = self._sweep_slabs.setdefault(token, {})
        got = slabs.get(x0)
        if got is None:
            span = self.compiled.layers[0].os_spec.span
            got = self._stager.stage(self._sweep_hosts[token][:, x0 : x0 + span])
            slabs[x0] = got
            self._ledger.alloc(_nbytes(got[0]))
        return got

    def _drop_slabs(self, token: int, keep) -> None:
        slabs = self._sweep_slabs.get(token, {})
        for x0 in [x for x in slabs if x not in keep]:
            self._ledger.free(_nbytes(slabs.pop(x0)[0]))

    def _evict_left_of(self, token: int, x_lo: int) -> None:
        """Free every cache entry strictly left of ``x_lo`` (both caches,
        and a streaming sweep's slabs).

        Exact by the tiler's non-decreasing-x patch stream: no later patch
        of this sweep can resolve an evicted key.
        """
        cache = self._sweeps.get(token, {})
        for dead in [k for k in cache if k[0] < x_lo]:
            del cache[dead]
            self._ledger.free(self._key_bytes.pop((token, dead), 0.0))
        halo_cache = self._halo_caches.get(token)
        if halo_cache:
            for dead in [k for k in halo_cache if k[0] < x_lo]:
                self._ledger.free(sum(_nbytes(h) for h in halo_cache.pop(dead)))
        if self.streaming:
            self._drop_slabs(
                token, {x for x in self._sweep_slabs.get(token, {}) if x >= x_lo}
            )

    # -- shard boundary handoff (sharded serving fleet) ----------------------

    def export_handoff(self, token: int, x_lo: int):
        """Stage this scope's boundary caches out to host.

        Returns a ``distributed.collectives.HaloPackage`` of every segment-
        spectrum row and activation-halo entry whose absolute-x key is
        >= ``x_lo``: exactly what a single-device sweep still holds when its
        next chunk starts at plane ``x_lo`` (everything left of it is
        evicted there).  Each row and entry is copied to a host tensor, so
        the package crosses workers and no view keeps a device parent
        alive; an import followed by an export gives back the same bits.
        """
        from ..distributed.collectives import HaloPackage

        spectra = {
            key: ref.parent[ref.idx].to("cpu", copy=True)
            for key, ref in self._sweeps.get(token, {}).items()
            if key[0] >= x_lo and isinstance(ref, _SpectrumRef)
        }
        halos = {
            key: tuple(h.to("cpu", copy=True) for h in entry)
            for key, entry in self._halo_caches.get(token, {}).items()
            if key[0] >= x_lo
        }
        return HaloPackage(x_lo=x_lo, spectra=spectra, halos=halos)

    def import_handoff(self, token: int, pkg) -> None:
        """File a predecessor shard's boundary package into this scope.

        Spectrum rows are grouped by absolute segment x and uploaded as one
        parent per x (the split ``_store_spectra`` keeps, so the per-key
        eviction sweep still frees whole buffers); halo entries upload per
        key.  Both are ledgered, as a single-device sweep holds them at
        this boundary.
        """
        if pkg is None or pkg.is_empty():
            return
        cache = self._sweeps.setdefault(token, {})
        by_x: Dict[int, List] = {}
        for key in sorted(pkg.spectra):
            by_x.setdefault(key[0], []).append(key)
        for _x, keys in sorted(by_x.items()):
            parent = torch.stack([pkg.spectra[k] for k in keys]).to(self.device)
            share = _nbytes(parent) / len(keys)
            self._ledger.alloc(_nbytes(parent))
            for i, key in enumerate(keys):
                cache[key] = _SpectrumRef(parent, i)
                self._key_bytes[(token, key)] = share
        halo_cache = self._halo_caches.setdefault(token, {})
        for key in sorted(pkg.halos):
            entry = [h.to(self.device, copy=True) for h in pkg.halos[key]]
            halo_cache[key] = entry
            self._ledger.alloc(sum(_nbytes(h) for h in entry))

    def handoff_entry_nbytes(self) -> Tuple[int, int]:
        """``(seg_row_bytes, halo_entry_bytes)`` of a boundary package.

        One layer-0 segment-spectrum row is the complex64 rfftn of an
        (f_in, *fft_shape) block; one activation-halo entry stacks, per
        layer below the input, the (frag, C_in, size-1, n, n) float32
        capture of the strip walk.  Every key's entry has the same size, so
        ``tiler.predict_shard_handoff``'s counts times these give the exact
        exchanged bytes.
        """
        if not self._os_reuse:
            raise ValueError("handoff accounting needs an overlap-save plan")
        fa, fb, fc = self.compiled.layers[0].os_spec.fft_shape
        seg_row = self.net.in_channels * fa * fb * (fc // 2 + 1) * 8
        halo_entry = 0
        if self.deep_reuse:
            c, n = self.net.in_channels, self.n_in
            for i, layer in enumerate(self.net.layers):
                if i > 0:
                    h, frag = self._strip_info[i]
                    halo_entry += frag * c * h * n * n * 4
                if layer.kind == "conv":
                    c = layer.out_channels
                    n = n - layer.size + 1
                else:
                    n = n // layer.size
        return int(seg_row), int(halo_entry)

    # -- the walks -------------------------------------------------------------

    def _walk(self, layers, states, x, S, *, capture: bool, halos_in=None):
        """Layers 1.. over a layer-0 output, optionally capturing halos.

        ``layers``/``states`` are the full walk's, or a strip's with
        ``halos_in``, the left neighbour's cached activation halos:
        ``halos_in[i-1]`` is prepended to layer i's input.  ReLU after every
        conv but the net's last; ``capture`` records per layer the trailing
        ``size - 1`` x-columns of its INPUT, the halos the next x-patch's
        strip assembles from.  With ``fuse_os`` each of ``_fused_pairs``
        runs as one ``fft_conv_pool_fused_halo`` call (lead ``halos_in[i]``)
        whose second output is the pool input's halo.  ``(out, halos)``.
        """
        # a full walk keeps its input referenced to its end, a strip frees
        # it at layer 1 (peak_device_gb counts the difference): as before
        held = x if halos_in is None else None
        halos = []
        i = 1
        while i < len(self.net.layers):
            pl = layers[i]
            with span(f"exec.layer.{i}"):
                if halos_in is not None:
                    x = torch.cat([halos_in[i - 1], x], dim=2)
                if capture:
                    h = self.net.layers[i].size - 1
                    halos.append(x[:, :, -h:])
                if self.fuse_os and i in self._fused_pairs:
                    p = layers[i + 1].pool_size
                    x, pool_halo = fft_conv_pool_fused_halo(
                        x, states[i]["W"], states[i]["b"],
                        fft_shape=pl.fft_shape, k=pl.kernel_size, p=p, halo_cols=p - 1,
                        lead=None if halos_in is None else halos_in[i],
                        use_kernels=self._use_kernels, fprime_chunk=pl.fprime_chunk,
                    )
                    if capture:
                        halos.append(pool_halo)
                    i += 2
                    continue
                x = resolve_primitive(pl).apply(
                    pl, x, states[i], use_kernels=self._use_kernels
                )
                if pl.kind == "conv" and i != self._last_conv:
                    x = torch.relu(x)
            i += 1
        if self.uses_mpf:
            with span("exec.recombine"):
                x = recombine_fragments(x, list(self.compiled.mpf_pools), S)
        del held
        return x, tuple(halos)

    def _layer0(self, states, F, out_cols: int):
        """Layer 0 from segment spectra F (S, q, f, ña, ñb, ñc), the last
        q segments: its trailing ``out_cols`` output columns, ReLU'd."""
        with span("exec.layer0"):
            x = os_mod.os_apply_tail_from_spectra(
                F, states[0]["W"], states[0]["b"], self.compiled.layers[0].os_spec,
                out_cols, use_kernels=self._use_kernels,
            )
            if self._last_conv != 0:
                x = torch.relu(x)
        return x

    def _assemble_spectra(self, Fm, parents, pattern, rows_per_patch):
        """Stack the (S·rows_per_patch) spectra rows a step needs: slot
        ``(-1, j)`` is miss row j, ``(p, j)`` row j of cached parent p."""
        rows = [Fm[j] if p < 0 else parents[p][j] for p, j in pattern]
        S = len(pattern) // rows_per_patch
        return torch.stack(rows).reshape((S, rows_per_patch) + tuple(rows[0].shape))

    def _os_step(self, states, strip_states, vol, starts, parents, halos_in, *, pattern):
        """One patch batch: miss FFTs + assembly + layer 0 + the walk below
        it, capturing halos under deep reuse.  An interior strip batch
        (``halos_in`` given) pays layer 0's MAD + inverse only for the
        ``tail_segments`` of its new core columns.  Returns the outputs,
        the miss spectra and the captured halos."""
        strip = halos_in is not None
        spec0 = self.compiled.layers[0].os_spec
        Fm = None
        if starts is not None:
            with span("exec.segment_fft"):
                Fm = os_mod.slice_segment_spectra(vol, starts, spec0, self.extent)
        with span("exec.assemble"):
            F = self._assemble_spectra(
                Fm, parents, pattern, self._q_strip if strip else spec0.n_segments
            )
        out, halos = self._walk(
            self._strip_layers if strip else self.compiled.layers,
            strip_states if strip else states,
            self._layer0(states, F, self.core if strip else spec0.out[0]),
            F.shape[0], capture=self.deep_reuse, halos_in=halos_in,
        )
        return out, Fm, halos

    # -- batches ---------------------------------------------------------------

    def _run_os_batch(self, meta) -> np.ndarray:
        """Patch batch with layer-0 segment spectra served from the cache.

        ``meta[i] = (sweep_token, segment_keys, patch_start)``.  Single-
        sweep batches partition into the full-extent group and (under deep
        reuse) the interior-strip group — eligibility decided against the
        halo cache as of the chunk start — each run as one step.  Mixed-
        sweep batches (cross-request serving ticks) go through
        ``_run_os_batch_mixed``.
        """
        tokens = {mm[0] for mm in meta}
        if len(tokens) > 1:
            return self._run_os_batch_mixed(meta)
        token = next(iter(tokens))
        with span("exec.resolve"):
            groups = self._os_groups(token, meta)
        halo_cache = self._halo_caches[token]
        outs: List[Optional[np.ndarray]] = [None] * len(meta)
        for rows, strip in groups:
            ys, halos = self._run_os_group(token, [meta[i] for i in rows], strip)
            for j, idx in enumerate(rows):
                outs[idx] = ys[j]
            if self.deep_reuse:
                with span("exec.store"):
                    self._store_halos(halo_cache, [meta[i] for i in rows], halos)
        with span("exec.gather"):
            return np.stack(outs)

    def _os_groups(self, token, meta) -> List[Tuple[List[int], bool]]:
        """Evict what the batch moved past, then partition its rows into
        the full group and the interior-strip group (per x-plane when
        streaming): ``[(rows, strip)]``."""
        self._sweeps.setdefault(token, {})
        halo_cache = self._halo_caches.setdefault(token, {})
        # keyed by patch START, so a strip patch never evicts a key a
        # same-plane full patch still needs
        x_lo = min(mm[2][0] for mm in meta)
        self._evict_left_of(token, x_lo)
        full_rows: List[int] = []
        strip_rows: List[int] = []
        for idx, (_, keys, start) in enumerate(meta):
            eligible = (
                self.deep_reuse
                and start[0] > 0
                and start[0] % self.core == 0
                and start in halo_cache
            )
            (strip_rows if eligible else full_rows).append(idx)
        groups: List[Tuple[List[int], bool]] = []
        for rows, strip in ((full_rows, False), (strip_rows, True)):
            if not rows:
                continue
            if self.streaming:
                # one staged slab serves one x-plane: sub-partition the
                # group so every step reads a single slab (serving ticks
                # can pop patches spanning planes; offline chunks are
                # already plane-capped)
                by_plane: Dict[int, List[int]] = {}
                for i in rows:
                    by_plane.setdefault(meta[i][2][0], []).append(i)
                groups.extend((by_plane[x], strip) for x in sorted(by_plane))
            else:
                groups.append((rows, strip))
        return groups

    def _run_os_group(self, token, metas, strip: bool):
        """Resolve + run one homogeneous (full or strip) patch group.

        Resolution inserts ``_PendingMiss`` markers, so repeated keys
        within the group dedup; the strip group runs after the full group
        and sees its fresh ``_SpectrumRef``s.  Returns ``(outputs, halos)``.
        """
        cache = self._sweeps[token]
        states, strip_states = self._states_for_axis(
            self._sweep_axes.get(token, self.sweep_axis)
        )
        with span("exec.resolve"):
            misses, pattern, parents = self._resolve_keys(cache, metas, strip)
        if self.streaming:
            # the group is one x-plane: its segments all lie in the staged
            # slab [x0, x0 + span), so miss starts shift into slab
            # coordinates and the step's volume operand keeps one shape
            x0 = metas[0][2][0]
            with span("exec.upload"):
                vol, ready = self._slab(token, x0)
                self._stager.wait(ready)
            off = np.asarray([x0, 0, 0], np.int64)
        else:
            vol = self._sweep_vols[token]
            off = np.zeros(3, np.int64)
        starts = np.asarray(misses, np.int64) - off if misses else None
        halos_in = None
        if strip:
            with span("exec.assemble"):
                halos_in = tuple(
                    torch.cat(
                        [self._halo_caches[token][m[2]][pos] for m in metas], dim=0
                    )
                    for pos in range(len(self.net.layers) - 1)
                )
        self._record_trace(
            ("strip" if strip else "full", tuple(pattern),
             None if starts is None else len(misses), tuple(vol.shape), len(parents))
        )
        out, F_m, halos = self._os_step(
            states, strip_states, vol, starts, tuple(parents), halos_in,
            pattern=tuple(pattern),
        )
        if strip:
            self._deep_strips += len(metas)
        else:
            self._deep_fulls += len(metas)
        # transient sample: group output + miss spectra + captured halos in
        # flight on top of the resident working set
        self._ledger.transient(
            _nbytes(out)
            + (_nbytes(F_m) if F_m is not None else 0)
            + sum(_nbytes(h) for h in halos)
        )
        with span("exec.store"):
            self._store_spectra(token, cache, misses, F_m)
        with span("exec.copy_back"):
            return out.cpu().numpy(), halos

    def _resolve_keys(self, cache, metas, strip: bool):
        """A group's segment keys against the sweep's cache: ``(misses,
        pattern, parents)``, each miss filed as a ``_PendingMiss``; counts
        the hits, misses, MAD segments and fused-pair calls."""
        n_seg = self.compiled.layers[0].os_spec.n_segments
        q = self._q_strip if strip else n_seg
        misses: List[Tuple[int, int, int]] = []
        pattern: List[Tuple[int, int]] = []
        parents: List = []
        parent_pos: Dict[int, int] = {}
        for _, keys, _start in metas:
            for key in keys[n_seg - q :] if strip else keys:
                F = cache.get(key)
                if F is None:
                    F = _PendingMiss(len(misses))
                    cache[key] = F
                    misses.append(key)
                    self._os_misses += 1
                else:
                    self._os_hits += 1
                if isinstance(F, _PendingMiss):
                    pattern.append((-1, F.idx))
                else:
                    pos = parent_pos.get(id(F.parent))
                    if pos is None:
                        pos = parent_pos[id(F.parent)] = len(parents)
                        parents.append(F.parent)
                    pattern.append((pos, F.idx))
        self._os_mad_segments += len(pattern)
        if self.fuse_os:
            self._fused_pair_calls += len(metas) * len(self._fused_pairs)
        return misses, pattern, parents

    def _store_spectra(self, token, cache, misses, F_m) -> None:
        """File a group's miss spectra, split by absolute segment x, so the
        per-key eviction sweep frees whole buffers."""
        if not misses:
            return
        by_x: Dict[int, List[int]] = {}
        for i, key in enumerate(misses):
            by_x.setdefault(key[0], []).append(i)
        for _x, idxs in by_x.items():
            if len(idxs) == len(misses):
                parent = F_m
            else:
                parent = F_m.index_select(
                    0, torch.as_tensor(idxs, dtype=torch.long, device=F_m.device)
                )
            self._ledger.alloc(_nbytes(parent))
            share = _nbytes(parent) / len(idxs)
            for j, i in enumerate(idxs):
                cache[misses[i]] = _SpectrumRef(parent, j)
                self._key_bytes[(token, misses[i])] = share

    def _store_halos(self, halo_cache, metas, halos) -> None:
        """File a group's trailing activation halos for the x-successors.

        ``halos[pos]`` stacks the whole group (fragment-expanded batch);
        patch j owns rows [j·frag, (j+1)·frag).  Only core-aligned patches
        store.  Each entry is copied out, so it does not keep the group's
        whole activation alive.
        """
        for j, (_, _, start) in enumerate(metas):
            if start[0] % self.core:
                continue
            entry = []
            for pos in range(len(self.net.layers) - 1):
                _, frag = self._strip_info[pos + 1]
                entry.append(halos[pos][j * frag : (j + 1) * frag].clone())
            key = (start[0] + self.core, start[1], start[2])
            old = halo_cache.get(key)
            if old is not None:
                self._ledger.free(sum(_nbytes(h) for h in old))
            halo_cache[key] = entry
            self._ledger.alloc(sum(_nbytes(h) for h in entry))

    def _run_os_batch_mixed(self, meta) -> np.ndarray:
        """Cross-request serving batches: one batched FFT per sweep, then
        the spectra-stack walk (full path; deep reuse resumes on the next
        single-sweep tick — mixed ticks don't store halos)."""
        spec0 = self.compiled.layers[0].os_spec
        with span("exec.resolve"):
            slots, miss_keys = self._resolve_mixed(meta)
        for token, keys_m in miss_keys.items():
            # pad the miss count to a power of two (the reference bounds its
            # compiled FFT batch sizes this way; the ledger counts the rows)
            M = len(keys_m)
            Mp = 1
            while Mp < M:
                Mp *= 2
            starts = np.asarray(keys_m + [keys_m[-1]] * (Mp - M), np.int64)
            if self.streaming:
                # a transient slab covering this scope's misses; its shape
                # varies per tick (the single-sweep path is the one with
                # the constant-shape slab)
                x_min = min(k[0] for k in keys_m)
                x_hi = max(k[0] for k in keys_m) + spec0.seg_extent
                with span("exec.upload"):
                    vol, ready = self._stager.stage(self._sweep_hosts[token][:, x_min:x_hi])
                    self._stager.wait(ready)
                self._ledger.transient(_nbytes(vol))
                starts = starts - np.asarray([x_min, 0, 0], np.int64)
            else:
                vol = self._sweep_vols[token]
            with span("exec.segment_fft"):
                F_all_miss = os_mod.slice_segment_spectra(vol, starts, spec0, self.extent)
            self._ledger.transient(_nbytes(F_all_miss))
            with span("exec.store"):
                self._store_spectra(
                    token, self._sweeps[token], keys_m, F_all_miss[:M]
                )
        # requests on different axes walk different states: one stacked
        # walk per axis group, outputs put back in meta order
        by_axis: Dict[int, List[int]] = {}
        for i, (token, _, _) in enumerate(meta):
            by_axis.setdefault(self._sweep_axes.get(token, self.sweep_axis), []).append(i)
        outs: List[Optional[np.ndarray]] = [None] * len(meta)
        for axis in sorted(by_axis):
            rows = by_axis[axis]
            with span("exec.assemble"):
                flat = []
                for i in rows:
                    cache = self._sweeps[meta[i][0]]
                    for key, F in slots[i]:
                        if isinstance(F, _PendingMiss):
                            F = cache[key]  # _store_spectra filed the real ref
                        flat.append(F.parent[F.idx])
                F_all = torch.stack(flat).reshape(
                    (len(rows), spec0.n_segments) + tuple(flat[0].shape)
                )
            self._record_trace(("oswalk", tuple(F_all.shape)))
            states, _ = self._states_for_axis(axis)
            out, _ = self._walk(
                self.compiled.layers, states, self._layer0(states, F_all, spec0.out[0]),
                F_all.shape[0], capture=False,
            )
            self._ledger.transient(_nbytes(F_all) + _nbytes(out))
            with span("exec.copy_back"):
                out = out.cpu().numpy()
            for j, i in enumerate(rows):
                outs[i] = out[j]
        with span("exec.gather"):
            return np.stack(outs)

    def _resolve_mixed(self, meta):
        """Each patch's segment keys against its own sweep's cache, after
        evicting what that sweep moved past: ``(slots, miss_keys)``, per
        patch its ``(key, ref)`` pairs and per sweep its missing keys."""
        slots: List[List] = []
        miss_keys: Dict[int, List[Tuple[int, int, int]]] = {}
        n_seg = self.compiled.layers[0].os_spec.n_segments
        for token, keys, start in meta:
            cache = self._sweeps.setdefault(token, {})
            self._evict_left_of(token, start[0])
            per_seg = []
            for key in keys:
                F = cache.get(key)
                if F is None:
                    misses = miss_keys.setdefault(token, [])
                    F = _PendingMiss(len(misses))
                    cache[key] = F
                    misses.append(key)
                    self._os_misses += 1
                else:
                    self._os_hits += 1
                per_seg.append((key, F))
            slots.append(per_seg)
            self._os_mad_segments += n_seg
            if self.fuse_os:
                self._fused_pair_calls += len(self._fused_pairs)
            self._deep_fulls += 1
        return slots, miss_keys

    def padded_batch_size(self, n: int) -> int:
        """Batch size to run for ``n`` ready patches: ``n`` itself when it is
        full or already seen, otherwise the next power of two (capped at
        ``batch``), bounding the distinct step shapes to O(log batch)."""
        if n >= self.batch or n in self._seen_batch_sizes:
            return min(n, self.batch)
        s = 1
        while s < n:
            s *= 2
        return min(s, self.batch)

    def run_patch_batch(self, xs: Optional[np.ndarray], *, meta=None) -> np.ndarray:
        """(S, f, extent³) patches -> (S, out_ch, core³) dense cores.

        ``meta`` (overlap-save reuse): per-patch ``(sweep_token,
        segment_keys, patch_start)`` naming each patch's layer-0 segments
        by absolute volume coordinates; ``xs`` may then be None.  Without
        ``meta`` the self-contained dense walk runs over the raw patches.
        """
        if self._os_reuse and meta is not None:
            self._seen_batch_sizes.add(len(meta))
            return self._run_os_batch(meta)
        S = xs.shape[0]
        self._seen_batch_sizes.add(S)
        if self.uses_mpf:
            self._record_trace(("walk", xs.shape))
            with span("exec.walk"):
                y = self.compiled.apply(self._upload(xs), recombine=True)
            self._ledger.transient(xs.nbytes + _nbytes(y))
            with span("exec.copy_back"):
                return y.cpu().numpy()
        # baseline: all-subsamplings outer loop (P³ shifted passes)
        out = np.empty((S, self.out_channels) + (self.core,) * 3, np.float32)
        n = self.n_in
        for ox, oy, oz in itertools.product(range(self.P), repeat=3):
            sub = xs[:, :, ox : ox + n, oy : oy + n, oz : oz + n]
            with span("exec.walk"):
                yd = self.compiled.apply(self._upload(sub), recombine=False)
            self._ledger.transient(sub.nbytes + _nbytes(yd))
            with span("exec.copy_back"):
                out[:, :, ox :: self.P, oy :: self.P, oz :: self.P] = yd.cpu().numpy()
        return out

    @spanned("exec.upload")
    def _upload(self, xs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(xs, np.float32), device=self.device
        )

    # -- volume sweep --------------------------------------------------------

    def run(self, vol: np.ndarray, *, sweep_axis: Optional[int] = None) -> np.ndarray:
        """Sweep (f, X, Y, Z) -> dense (out_ch, X-FOV+1, Y-FOV+1, Z-FOV+1).

        Output is in the VOLUME frame, whatever the sweep axis.
        ``sweep_axis`` overrides the executor's axis for this run (overlap-
        save reuse plans only: the other paths run on the executor's own
        axis's compiled states).
        """
        vol = np.asarray(vol, np.float32)
        axis = self.sweep_axis if sweep_axis is None else int(sweep_axis)
        if axis != self.sweep_axis and not (self._os_reuse and self.theta < 0):
            raise ValueError(
                "per-run sweep_axis override needs an overlap-save reuse plan"
            )
        tiling = self.tiling_for(vol.shape[1:], sweep_axis=axis)
        padded = pad_volume(vol, tiling)  # working frame (sweep axis first)
        out = np.empty(
            (self.out_channels,) + tiling.to_volume_frame(tiling.out_shape),
            np.float32,
        )
        self._os_misses = self._os_hits = self._os_mad_segments = 0
        self._deep_strips = self._deep_fulls = 0
        self._fused_pair_calls = 0
        seg0 = _seg_ops.segments["os_segment"]
        self._ledger.begin_run()  # peak scoped to this sweep
        t0 = time.perf_counter()
        # the device upload is real per-volume work, so it is timed
        sweep = (
            self.begin_sweep(padded, sweep_axis=axis)
            if self._os_reuse and self.theta < 0 else None
        )
        try:
            if self.theta >= 0:
                run_split = self._run_hetero if self.hetero else self._run_pipeline
                n_batches, padded_patches = run_split(padded, tiling, out)
            else:
                n_batches, padded_patches = self._run_batched(
                    padded, tiling, out, sweep
                )
        finally:
            self.end_sweep(sweep)
        dt = time.perf_counter() - t0

        vox = float(np.prod(out.shape[1:]))
        self.last_stats = {
            "patches": tiling.n_patches,
            "batches": n_batches,
            "padded_patches": padded_patches,
            "seconds": dt,
            "out_voxels": vox,
            "measured_voxps": vox / dt if dt > 0 else float("inf"),
            "predicted_voxps": self.plan.throughput if self.plan else float("nan"),
            "waste_fraction": tiling.waste_fraction,
            "os_seg_fft": self._os_misses,
            "os_seg_hits": self._os_hits,
            "os_mad_segments": self._os_mad_segments,
            "deep_strip_patches": self._deep_strips,
            "deep_full_patches": self._deep_fulls,
            "fused_pair_calls": self._fused_pair_calls,
            "os_fused_segments": _seg_ops.segments["os_segment"] - seg0,
            "retraces": len(self._trace_keys),
            "peak_device_bytes": self._ledger.peak,
            "predicted_peak_device_bytes": (
                self.predict_memory(vol.shape[1:], sweep_axis=axis).device_bytes
                if self._os_reuse and self.theta < 0 else float("nan")
            ),
        }
        if self.hetero:
            # per-stage and hand-off counters beside their plan predictions
            self.last_stats.update(self._hetero_stats)
        return out

    # -- memory model --------------------------------------------------------

    def predict_memory(
        self, vol_shape: Sequence[int], *, sweep_axis: Optional[int] = None
    ):
        """Predicted peak device working set for sweeping ``vol_shape``
        (``planner.plan_stream_memory`` for this executor's mode), memoized
        per (shape, axis)."""
        if not self._os_reuse:
            raise ValueError("predict_memory needs an overlap-save reuse plan")
        axis = self.sweep_axis if sweep_axis is None else int(sweep_axis)
        key = tuple(int(x) for x in vol_shape) + (axis,)
        hit = self._predict_memory_cache.get(key)
        if hit is not None:
            return hit
        from ..core.planner import plan_stream_memory

        mem = plan_stream_memory(
            self.net, self.prims, self.m, key[:3],
            batch=self.batch, deep_reuse=self.deep_reuse,
            streaming=self.streaming, sweep_axis=axis,
        )
        self._predict_memory_cache[key] = mem
        return mem

    def sweep_bytes_estimate(
        self, vol_shape: Sequence[int], *, sweep_axis: Optional[int] = None
    ) -> float:
        """Device bytes OPENING a sweep over ``vol_shape`` would add: the
        predicted peak minus the always-resident prepared states."""
        mem = self.predict_memory(vol_shape, sweep_axis=sweep_axis)
        return mem.device_bytes - mem.spectra_bytes

    def write_core(self, out, tiling, spec, y) -> None:
        """Crop a patch's dense core (out_ch, core³) into the VOLUME-frame
        output, transposing back from the working frame."""
        c = tiling.core
        perm, inv = tiling.perm, tiling.inv_perm
        sls = []
        for i in range(3):
            s = spec.start[i]
            sls.append(slice(s, min(s + c, out.shape[1 + perm[i]])))
        y = y[:, : sls[0].stop - sls[0].start,
              : sls[1].stop - sls[1].start, : sls[2].stop - sls[2].start]
        if perm == (0, 1, 2):
            out[:, sls[0], sls[1], sls[2]] = y
        else:
            out[(slice(None),) + tuple(sls[inv[a]] for a in range(3))] = (
                np.transpose(y, (0,) + tuple(1 + inv[a] for a in range(3)))
            )

    def _run_batched(self, padded, tiling, out, sweep):
        """Sweep the patches in batches of ``batch``; a ragged tail runs as a
        smaller batch.

        Reuse sweep (``sweep`` set): chunks capped at x-plane boundaries so
        every aligned interior patch's left neighbour completed in an
        EARLIER chunk; each chunk's walk starts from cached/computed
        segment spectra of the sweep's resident volume (or, streaming, of
        its staged slab).  Dense sweep: the patches are cut from the padded
        host volume and walked as raw input.
        """
        S = self.batch
        specs = tiling.patches
        n_batches = 0
        if sweep is not None:
            chunks = [[specs[i] for i in idxs] for idxs in chunk_patches(tiling, S)]
        else:
            chunks = [list(specs[i : i + S]) for i in range(0, len(specs), S)]
        for ci, chunk in enumerate(chunks):
            if sweep is not None and self.streaming:
                # double-buffered staging: release planes the stream moved
                # past, keep/stage the current plane, and start the NEXT
                # plane's copy so it overlaps the current chunk's step
                keep = {chunk[0].start[0]}
                if ci + 1 < len(chunks):
                    keep.add(chunks[ci + 1][0].start[0])
                self._drop_slabs(sweep, keep)
                for x0 in sorted(keep):
                    self._slab(sweep, x0)
            if sweep is not None:
                meta = [(sweep, tiling.segment_keys(s), s.start) for s in chunk]
                ys = self.run_patch_batch(None, meta=meta)
            else:
                xs = np.stack(
                    [extract_patch(padded, s, tiling.extent) for s in chunk]
                )
                ys = self.run_patch_batch(xs)
            for spec, y in zip(chunk, ys):
                self.write_core(out, tiling, spec, y)
            n_batches += 1
        return n_batches, 0

    def _run_pipeline(self, padded, tiling, out):
        """pipeline2: stream patch chunks through the two-stage loop.

        One process holds both stages (the reference's ring with
        ``n_pods = 1``) unless a default ``torch.distributed`` group is
        initialized: then its n ranks form the ring.  The chunk count is
        padded to a multiple of n (the padding repeats the last patch),
        each rank runs its contiguous local stream (the reference's
        ``P("pod")`` split), and the outputs are gathered through host
        memory and rolled by one local-stream length, since rank r's
        outputs are rank r-1's patches.  Every rank returns the whole
        volume.
        """
        S = self.batch
        specs = list(tiling.patches)
        n_chunks = math.ceil(len(specs) / S)
        n_ranks, rank = group_size(), group_rank()
        # equal local stream length per rank: pad the chunk count
        T = math.ceil(n_chunks / n_ranks) * n_ranks
        T_local = T // n_ranks
        xs_all = np.empty((T, S, padded.shape[0]) + (tiling.extent,) * 3, np.float32)
        chunk_specs: List[List] = []
        for t in range(T):
            chunk = specs[t * S : (t + 1) * S] or [specs[-1]]
            chunk_specs.append(chunk)
            for j in range(S):
                spec = chunk[min(j, len(chunk) - 1)]
                xs_all[t, j] = extract_patch(padded, spec, tiling.extent)
        stage0, stage1 = make_stage_fns(self.compiled, self.theta)
        # the schedule stages the whole patch stream at once
        self._ledger.transient(xs_all.nbytes)
        local = xs_all[rank * T_local : (rank + 1) * T_local]
        ys = pipelined_apply(stage0, stage1, self._upload(local))
        if n_ranks > 1:
            # ring hand-off: rank r's local outputs are rank r-1's patches;
            # roll the rank-major chunk axis by one local-stream length
            ys = all_gather_cat(ys, 0)
            ys = torch.roll(ys.reshape((n_ranks, T_local) + ys.shape[1:]), -1, 0)
            ys = ys.reshape((T,) + ys.shape[2:])
        pools = list(self.compiled.mpf_pools)
        for t, chunk in enumerate(chunk_specs[:n_chunks]):
            y = ys[t]
            if pools:
                y = recombine_fragments(y, pools, S)
            y = y.cpu().numpy()
            for j, spec in enumerate(chunk):
                self.write_core(out, tiling, spec, y[j])
        return T, T * S - tiling.n_patches

    def _run_hetero(self, padded, tiling, out):
        """hetero: the two stages on their devices, host RAM in between.

        Stage 0 (layers [0, θ)) and stage 1 (layers [θ, L) + MPF
        recombination) run on ``stage_devices``, each with its own copy of
        the prepared states there; a stage on the CPU runs the plain
        versions (``use_kernels`` resolves to them: a CPU stage is never
        handed ``True``).  The split activation crosses as an explicit,
        measured copy device 0 → pinned host buffer → device 1 (the
        paper's §VII-C "host RAM is the shared medium"), its bytes counted.
        Each chunk runs the two stages back to back, each timed to a
        synchronize: measured wall time is t0 + t1 + xfer per chunk, where
        the plan's steady state is max(t0, t1) + xfer.  The hand-off
        *bytes* match ``Plan.xfer_bytes`` exactly (the per-patch size is
        chunk-size independent).  The stage on the executor's device reads
        the compiled states in place (the reference ``device_put``s and
        ledgers a second copy), so the ledger adds nothing for them.
        """
        S = self.batch
        specs = list(tiling.patches)
        devs = self.stage_devices
        pools = list(self.compiled.mpf_pools)
        layers = self.compiled.layers
        bounds = ((0, self.theta), (self.theta, len(layers)))
        if self._hetero_states is None:
            states = self.compiled.states
            self._hetero_states = tuple(
                states[lo:hi] if d == self.device else _states_to(states[lo:hi], d)
                for d, (lo, hi) in zip(devs, bounds)
            )
        kernels = tuple(
            self._use_kernels if d == self.device
            else (False if self._use_kernels is False else None)
            for d in devs
        )
        pinned = any(d.type == "cuda" for d in devs)

        def stage(k, x):
            lo, hi = bounds[k]
            return apply_prepared_range(
                self.net, layers[lo:hi], x, states=self._hetero_states[k],
                use_kernels=kernels[k], fuse_pairs=self.fuse_pairs,
            )

        stage0_s = stage1_s = xfer_s = 0.0
        xfer_bytes = 0.0
        n_chunks = 0
        for i in range(0, len(specs), S):
            chunk = specs[i : i + S]  # ragged tail runs at true size
            xs = np.stack([extract_patch(padded, s, tiling.extent) for s in chunk])
            self._record_trace(("hetero", xs.shape))
            t = time.perf_counter()
            a = stage(0, torch.as_tensor(xs, device=devs[0]))
            _sync(devs[0])
            t2 = time.perf_counter()
            stage0_s += t2 - t
            # the hand-off: device 0 → pinned host RAM → device 1
            a_host = torch.empty(a.shape, dtype=a.dtype, pin_memory=pinned)
            a_host.copy_(a)
            a1 = a_host.to(devs[1], non_blocking=True)
            _sync(devs[1])
            t3 = time.perf_counter()
            xfer_s += t3 - t2
            xfer_bytes += _nbytes(a_host)
            y = stage(1, a1)
            if pools:
                y = recombine_fragments(y, pools, len(chunk))
            _sync(devs[1])
            stage1_s += time.perf_counter() - t3
            self._ledger.transient(xs.nbytes + _nbytes(a) + _nbytes(y))
            for spec, yy in zip(chunk, y.cpu().numpy()):
                self.write_core(out, tiling, spec, yy)
            n_chunks += 1

        plan = self.plan
        scale = tiling.n_patches / plan.batch  # plan counters are per batch
        self._hetero_stats = {
            "stage0_seconds": stage0_s,
            "stage1_seconds": stage1_s,
            "xfer_seconds": xfer_s,
            "xfer_bytes": xfer_bytes,
            "predicted_stage0_seconds": plan.stage_times[0] * scale,
            "predicted_stage1_seconds": plan.stage_times[1] * scale,
            "predicted_xfer_seconds": plan.xfer_seconds * scale,
            "predicted_xfer_bytes": plan.xfer_bytes * scale,
        }
        return n_chunks, 0


def tiled_apply(
    params,
    net: ConvNetConfig,
    vol: np.ndarray,
    prims: Sequence[str],
    m: int,
    *,
    batch: int = 1,
    use_kernels: Optional[bool] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """One-shot tiled inference without a Plan (tests, notebooks);
    ``device=None`` means the card."""
    ex = PlanExecutor(
        params, net, prims=prims, m=m, batch=batch, use_kernels=use_kernels,
        device=device,
    )
    return ex.run(vol)
