"""Plan-driven patch executor: run a planner ``Plan`` over a whole volume.

``PlanExecutor`` compiles a plan (per-layer primitives + patch geometry)
into a ``primitives.CompiledPlan`` — cached kernel spectra for
``fft_cached`` and ``overlap_save`` layers, per-layer pruned-FFT shapes,
pool modes — and sweeps a volume patch by patch.  Patch-geometry
invariants (see ``tiler``): every patch spans ``extent = core + FOV - 1``
input voxels and contributes a ``core³`` dense block; adjacent patches
overlap by FOV-1 input voxels; edge patches are *shifted*; the patch
stream is x-major with non-decreasing x.

This port carries the configuration the volume runtime deploys: the plan's
FIRST conv is ``overlap_save`` with its segment grid pinned to the patch
core, deeper convs are ``fft_cached``, pools are ``mpf``.

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
* ``_DeviceLedger`` accounts every executor-managed device buffer;
  ``last_stats["peak_device_bytes"]`` reports its per-sweep peak, which
  ``predict_memory`` reproduces.

PyTorch runs eagerly, so nothing is traced; the executor still records
the distinct step keys the reference's jit would specialize on, so
``last_stats["retraces"]`` keeps its meaning.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): the dense walk of non-reuse plans (``run_patch_batch(xs)``,
``tiled_apply``), host-staged streaming (``ram_budget``/``streaming``),
per-request sweep axes other than the executor's, the boundary handoff of
the sharded fleet, tuned configs, and the ``hetero``/``pipeline2`` split
strategies.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ConvNetConfig
from ..core import overlap_save as os_mod
from ..core.fft_conv import fft_conv_pool_fused_halo
from ..core.mpf import recombine_fragments
from ..core.planner import Plan
from ..core.primitives import (
    CompiledPlan,
    PreparedLayer,
    compile_plan,
    conv_primitive,
    plan_input_size,
    pool_primitive,
    resolve_primitive,
)
from ..kernels.dispatch import DeviceLike, resolve_device, resolve_use_kernels
from ..kernels.os_segment import ops as _seg_ops
from .tiler import (
    HaloSpec,
    SweepCounts,
    VolumeTiling,
    chunk_patches,
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
    states, cached segment spectra, activation halos, a sweep's resident
    volume); ``transient`` samples a step's in-flight extras on top of
    ``current``.  ``peak`` is ``last_stats["peak_device_bytes"]``, which
    the planner's ``predict_stream_peak`` simulation reproduces.
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


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
        use_kernels: Optional[bool] = None,
        fuse_pairs: Optional[bool] = None,
        fprime_chunk=None,
        fuse_os: Optional[bool] = None,
        tuned="auto",
        deep_reuse: bool = True,
        ram_budget: Optional[float] = None,
        streaming: Optional[bool] = None,
        sweep_axis: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        # the port has no tuned-config store yet: "auto" finds nothing
        if tuned not in ("auto", None):
            raise _not_ported("tuned configs", "Queue 1 item 9")
        self.tuned = None
        if sweep_axis is None:
            sweep_axis = getattr(plan, "sweep_axis", 0) if plan is not None else 0
        self.sweep_axis = int(sweep_axis)
        params = [
            None if p is None else (p[0].to(self.device), p[1].to(self.device))
            for p in params
        ]
        self.params = _permute_conv_params(params, net, sweep_perm(self.sweep_axis))
        self.net = net
        self.plan = plan
        if plan is not None:
            prims = plan.prims
            m = plan.m_final
            batch = batch or plan.batch
            if plan.strategy in ("pipeline2", "hetero"):
                raise _not_ported(
                    "the hetero/pipeline2 split strategies", "Queue 1 item 6h"
                )
            if ram_budget is None:
                ram_budget = plan.ram_budget
        if prims is None or m is None:
            raise ValueError("need either a Plan or explicit prims + m")
        if ram_budget is not None or streaming:
            raise _not_ported("host-staged streaming", "Queue 1 item 6e")
        self.streaming = False
        self.prims = tuple(prims)
        self.m = m
        self.batch = max(1, batch or 1)
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

        self.compiled: CompiledPlan = compile_plan(
            self.params, net, prims=self.prims, n_in=self.n_in,
            use_kernels=use_kernels, fuse_pairs=fuse_pairs,
            fprime_chunk=fprime_chunk, plan=plan,
            overlap_seg=self.core if self.prims[0] == "overlap_save" else None,
        )
        self.fuse_pairs = self.compiled.fuse_pairs
        self._fprime_chunk = fprime_chunk
        self._seen_batch_sizes: set = set()
        self.last_stats: Dict[str, float] = {}

        # -- overlap-save input-spectra reuse state --------------------------
        self._os_reuse = self.prims[0] == "overlap_save" and self.uses_mpf
        self._sweeps: Dict[int, Dict[Tuple[int, int, int], Any]] = {}
        self._sweep_vols: Dict[int, torch.Tensor] = {}
        self._key_bytes: Dict[Tuple[int, Tuple[int, int, int]], float] = {}
        self._sweep_counter = 0
        self._os_misses = 0
        self._os_hits = 0
        self._os_mad_segments = 0
        self._deep_strips = 0
        self._deep_fulls = 0
        self._fused_pair_calls = 0
        # layers below the input the halo-emitting fused epilogue can serve
        # as a conv+pool pair: fft_cached conv, not the net's last conv,
        # immediately followed by its mpf pool
        _last_conv = max(i for i, l in enumerate(net.layers) if l.kind == "conv")
        pairs = []
        for i in range(1, len(net.layers) - 1):
            pl_i = self.compiled.layers[i]
            nxt = self.compiled.layers[i + 1]
            if (
                pl_i.kind == "conv"
                and pl_i.prim == "fft_cached"
                and pl_i.index != _last_conv
                and nxt.kind == "pool"
                and nxt.prim == "mpf"
                and nxt.index == pl_i.index + 1
            ):
                pairs.append(i)
        self._fused_pairs: Tuple[int, ...] = tuple(pairs)
        self.fuse_os = bool(fuse_os) and bool(pairs) and self._os_reuse
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
        self._sweep_axes: Dict[int, int] = {}
        # prepared states (weights, cached kernel spectra at full AND strip
        # shapes) are resident for the executor's lifetime
        self._ledger = _DeviceLedger()
        strip_states = getattr(self, "_strip_states", [])
        self._ledger.alloc(_tree_nbytes(self.params, self.compiled.states, strip_states))
        self._predict_memory_cache: Dict[Tuple[int, int, int, int], Any] = {}

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

    def _states_for_axis(self, axis: int):
        """Prepared state lists ``(states, strip_states)`` for one axis."""
        if axis != self.sweep_axis:
            raise _not_ported(
                "a sweep axis other than the executor's", "Queue 1 item 6f"
            )
        return self.compiled.states, getattr(self, "_strip_states", None)

    def _build_strip_plan(self):
        """One-time setup of the interior-patch strip walk (layers >= 1).

        Binds each layer below the input to the strip extent an interior
        patch runs: ``new_x + size - 1`` sweep-axis columns at the full
        walk's cross extents.  Returns ``(layers, info)`` with
        ``info[i] = (halo columns, fragment batch multiplier)``.
        """
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
                    w, b = self.params[i]
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

    def begin_sweep(
        self, padded: np.ndarray, *, sweep_axis: Optional[int] = None
    ) -> int:
        """Open a fresh spectra-reuse scope (one volume sweep / request).

        Segment keys are absolute coordinates within one padded volume, so
        spectra never leak across requests.  ``padded`` must already be in
        the sweep axis's working frame.  The volume is extended along
        working axis 0 so the aligned grid's tail segments stay in bounds,
        then uploaded to the device once.
        """
        axis = self.sweep_axis if sweep_axis is None else int(sweep_axis)
        if axis != self.sweep_axis:
            raise _not_ported(
                "a sweep axis other than the executor's", "Queue 1 item 6f"
            )
        spec0 = self.compiled.layers[0].os_spec
        max_x0 = max(0, padded.shape[1] - self.extent)
        short = max(0, max_x0 + spec0.span - padded.shape[1])
        self._sweep_counter += 1
        token = self._sweep_counter
        self._sweeps[token] = {}
        self._sweep_axes[token] = axis
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
        for key in self._sweeps.pop(token, {}):
            self._ledger.free(self._key_bytes.pop((token, key), 0.0))
        for entry in self._halo_caches.pop(token, {}).values():
            self._ledger.free(sum(_nbytes(h) for h in entry))

    def _evict_left_of(self, token: int, x_lo: int) -> None:
        """Free every cache entry strictly left of ``x_lo`` (both caches).

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

    # -- the walks -------------------------------------------------------------

    def _walk_below_input(self, states, x, S, *, capture: bool):
        """Layers 1.. over a layer-0 output, optionally capturing halos.

        ReLU after every conv but the net's last; with ``capture`` records
        per layer the trailing ``size - 1`` x-columns of its INPUT — the
        activation halos the next x-patch's strip walk assembles from.
        With ``fuse_os`` every eligible conv+pool pair runs as one
        ``fft_conv_pool_fused_halo`` call whose second output is the pool
        input's halo.  Returns ``(out, halos)``.
        """
        last_conv = max(i for i, l in enumerate(self.net.layers) if l.kind == "conv")
        halos = []
        i = 1
        while i < len(self.net.layers):
            pl = self.compiled.layers[i]
            if capture:
                h = self.net.layers[i].size - 1
                halos.append(x[:, :, -h:])
            if self.fuse_os and i in self._fused_pairs:
                nxt = self.compiled.layers[i + 1]
                x, pool_halo = fft_conv_pool_fused_halo(
                    x, states[i]["W"], states[i]["b"],
                    fft_shape=pl.fft_shape, k=pl.kernel_size,
                    p=nxt.pool_size, halo_cols=nxt.pool_size - 1,
                    use_kernels=self._use_kernels,
                    fprime_chunk=pl.fprime_chunk,
                )
                if capture:
                    halos.append(pool_halo)
                i += 2
                continue
            x = resolve_primitive(pl).apply(
                pl, x, states[i], use_kernels=self._use_kernels
            )
            if pl.kind == "conv" and i != last_conv:
                x = torch.relu(x)
            i += 1
        if self.uses_mpf:
            x = recombine_fragments(x, list(self.compiled.mpf_pools), S)
        return x, tuple(halos)

    def _os_walk(self, states, F, *, capture: bool = False):
        """Forward from precomputed layer-0 segment spectra
        F (S, n_seg, f, ña, ñb, ñc).  Returns ``(out, halos)``."""
        pl0 = self.compiled.layers[0]
        x = os_mod.os_apply_from_spectra(
            F, states[0]["W"], states[0]["b"], pl0.os_spec,
            use_kernels=self._use_kernels,
        )
        last_conv = max(i for i, l in enumerate(self.net.layers) if l.kind == "conv")
        if last_conv != 0:
            x = torch.relu(x)
        return self._walk_below_input(states, x, F.shape[0], capture=capture)

    def _assemble_spectra(self, Fm, parents, pattern, rows_per_patch):
        """Stack the (S·rows_per_patch) spectra rows a step needs: slot
        ``(-1, j)`` is miss row j, ``(p, j)`` row j of cached parent p."""
        rows = [Fm[j] if p < 0 else parents[p][j] for p, j in pattern]
        S = len(pattern) // rows_per_patch
        return torch.stack(rows).reshape((S, rows_per_patch) + tuple(rows[0].shape))

    def _os_step(self, states, vol, starts, parents, *, pattern):
        """One full-path patch batch: miss FFTs + assembly + walk (+ halo
        capture).  Returns the miss spectra for the sweep cache and the
        halos for the deep activation cache."""
        spec0 = self.compiled.layers[0].os_spec
        Fm = None
        if starts is not None:
            Fm = os_mod.slice_segment_spectra(vol, starts, spec0, self.extent)
        F_all = self._assemble_spectra(Fm, parents, pattern, spec0.n_segments)
        out, halos = self._os_walk(states, F_all, capture=self.deep_reuse)
        return out, Fm, halos

    def _os_strip_step(
        self, states, strip_states, vol, starts, parents, halos, *, pattern
    ):
        """One interior-patch batch: the deep-reuse strip.

        Layer 0 pays MAD + inverse only for the ``tail_segments`` covering
        the batch's new core columns; every deeper layer runs on
        ``halos[i-1]`` (the left neighbour's cached activation halo)
        concatenated with the newly computed strip.  Returns the patch
        cores, the miss spectra, and the batch's own trailing halos.
        """
        spec0 = self.compiled.layers[0].os_spec
        Fm = None
        if starts is not None:
            Fm = os_mod.slice_segment_spectra(vol, starts, spec0, self.extent)
        F = self._assemble_spectra(Fm, parents, pattern, self._q_strip)
        S = F.shape[0]
        x = os_mod.os_apply_tail_from_spectra(
            F, states[0]["W"], states[0]["b"], spec0, self.core,
            use_kernels=self._use_kernels,
        )
        last_conv = max(i for i, l in enumerate(self.net.layers) if l.kind == "conv")
        if last_conv != 0:
            x = torch.relu(x)
        new_halos = []
        i = 1
        while i < len(self.net.layers):
            pl = self._strip_layers[i]
            h, _ = self._strip_info[i]
            x = torch.cat([halos[i - 1], x], dim=2)
            new_halos.append(x[:, :, -h:])
            if self.fuse_os and i in self._fused_pairs:
                # the pool layer's input is the cached lead halo halos[i] +
                # the conv's ReLU output, assembled inside the fused call
                nxt = self._strip_layers[i + 1]
                h_pool, _ = self._strip_info[i + 1]
                x, pool_halo = fft_conv_pool_fused_halo(
                    x, strip_states[i]["W"], strip_states[i]["b"],
                    fft_shape=pl.fft_shape, k=pl.kernel_size,
                    p=nxt.pool_size, halo_cols=h_pool, lead=halos[i],
                    use_kernels=self._use_kernels,
                    fprime_chunk=pl.fprime_chunk,
                )
                new_halos.append(pool_halo)
                i += 2
                continue
            x = resolve_primitive(pl).apply(
                pl, x, strip_states[i], use_kernels=self._use_kernels
            )
            if pl.kind == "conv" and i != last_conv:
                x = torch.relu(x)
            i += 1
        if self.uses_mpf:
            x = recombine_fragments(x, list(self.compiled.mpf_pools), S)
        return x, Fm, tuple(new_halos)

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
        outs: List[Optional[np.ndarray]] = [None] * len(meta)
        for rows, strip in ((full_rows, False), (strip_rows, True)):
            if not rows:
                continue
            ys, halos = self._run_os_group(token, [meta[i] for i in rows], strip)
            for j, idx in enumerate(rows):
                outs[idx] = ys[j]
            if self.deep_reuse:
                self._store_halos(halo_cache, [meta[i] for i in rows], halos)
        return np.stack(outs)

    def _run_os_group(self, token, metas, strip: bool):
        """Resolve + run one homogeneous (full or strip) patch group.

        Resolution inserts ``_PendingMiss`` markers, so repeated keys
        within the group dedup; the strip group runs after the full group
        and sees its fresh ``_SpectrumRef``s.  Returns ``(outputs, halos)``.
        """
        spec0 = self.compiled.layers[0].os_spec
        cache = self._sweeps[token]
        states, strip_states = self._states_for_axis(
            self._sweep_axes.get(token, self.sweep_axis)
        )
        n_seg = spec0.n_segments
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
        vol = self._sweep_vols[token]
        starts = np.asarray(misses, np.int64) if misses else None
        if strip:
            halos_in = tuple(
                torch.cat(
                    [self._halo_caches[token][m[2]][pos] for m in metas], dim=0
                )
                for pos in range(len(self.net.layers) - 1)
            )
            self._record_trace(
                ("strip", tuple(pattern), None if starts is None else len(misses),
                 tuple(vol.shape), len(parents))
            )
            out, F_m, halos = self._os_strip_step(
                states, strip_states, vol, starts, tuple(parents), halos_in,
                pattern=tuple(pattern),
            )
            self._deep_strips += len(metas)
        else:
            self._record_trace(
                ("full", tuple(pattern), None if starts is None else len(misses),
                 tuple(vol.shape), len(parents))
            )
            out, F_m, halos = self._os_step(
                states, vol, starts, tuple(parents), pattern=tuple(pattern)
            )
            self._deep_fulls += len(metas)
        # transient sample: group output + miss spectra + captured halos in
        # flight on top of the resident working set
        self._ledger.transient(
            _nbytes(out)
            + (_nbytes(F_m) if F_m is not None else 0)
            + sum(_nbytes(h) for h in halos)
        )
        self._store_spectra(token, cache, misses, F_m)
        return out.cpu().numpy(), halos

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
        slots: List[List] = []
        miss_keys: Dict[int, List[Tuple[int, int, int]]] = {}
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
            self._os_mad_segments += spec0.n_segments
            if self.fuse_os:
                self._fused_pair_calls += len(self._fused_pairs)
            self._deep_fulls += 1
        for token, keys_m in miss_keys.items():
            # pad the miss count to a power of two (the reference bounds its
            # compiled FFT batch sizes this way; the ledger counts the rows)
            M = len(keys_m)
            Mp = 1
            while Mp < M:
                Mp *= 2
            starts = np.asarray(keys_m + [keys_m[-1]] * (Mp - M), np.int64)
            F_all_miss = os_mod.slice_segment_spectra(
                self._sweep_vols[token], starts, spec0, self.extent
            )
            self._ledger.transient(_nbytes(F_all_miss))
            self._store_spectra(
                token, self._sweeps[token], keys_m, F_all_miss[:M]
            )
        # every open scope sweeps the executor's axis (begin_sweep enforces
        # it), so the whole tick walks as one stack
        flat = []
        for i, (token, _, _) in enumerate(meta):
            cache = self._sweeps[token]
            for key, F in slots[i]:
                if isinstance(F, _PendingMiss):
                    F = cache[key]  # _store_spectra filed the real ref
                flat.append(F.parent[F.idx])
        F_all = torch.stack(flat).reshape(
            (len(meta), spec0.n_segments) + tuple(flat[0].shape)
        )
        self._record_trace(("oswalk", tuple(F_all.shape)))
        states, _ = self._states_for_axis(self.sweep_axis)
        out, _ = self._os_walk(states, F_all)
        self._ledger.transient(_nbytes(F_all) + _nbytes(out))
        return out.cpu().numpy()

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
        """Patch batch -> (S, out_ch, core³) dense cores.

        ``meta`` (overlap-save reuse): per-patch ``(sweep_token,
        segment_keys, patch_start)`` naming each patch's layer-0 segments
        by absolute volume coordinates; ``xs`` may then be None.  The
        self-contained walk over raw patches ``xs`` is the dense path.
        """
        if self._os_reuse and meta is not None:
            self._seen_batch_sizes.add(len(meta))
            return self._run_os_batch(meta)
        raise _not_ported("the dense patch walk", "Queue 1 item 6a")

    # -- volume sweep --------------------------------------------------------

    def run(self, vol: np.ndarray, *, sweep_axis: Optional[int] = None) -> np.ndarray:
        """Sweep (f, X, Y, Z) -> dense (out_ch, X-FOV+1, Y-FOV+1, Z-FOV+1).

        Output is in the VOLUME frame, whatever the sweep axis.
        """
        vol = np.asarray(vol, np.float32)
        axis = self.sweep_axis if sweep_axis is None else int(sweep_axis)
        if axis != self.sweep_axis:
            raise _not_ported(
                "a sweep axis other than the executor's", "Queue 1 item 6f"
            )
        if not self._os_reuse:
            raise _not_ported("the dense patch walk", "Queue 1 item 6a")
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
        sweep = self.begin_sweep(padded, sweep_axis=axis)
        try:
            n_batches, padded_patches = self._run_batched(padded, tiling, out, sweep)
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
            ),
        }
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
        """The reuse sweep: chunks capped at x-plane boundaries so every
        aligned interior patch's left neighbour completed in an EARLIER
        chunk; each chunk's walk starts from cached/computed segment
        spectra of the sweep's resident volume."""
        specs = tiling.patches
        n_batches = 0
        chunks = [[specs[i] for i in idxs] for idxs in chunk_patches(tiling, self.batch)]
        for chunk in chunks:
            meta = [(sweep, tiling.segment_keys(s), s.start) for s in chunk]
            ys = self.run_patch_batch(None, meta=meta)
            for spec, y in zip(chunk, ys):
                self.write_core(out, tiling, spec, y)
            n_batches += 1
        return n_batches, 0
