"""Primitive registry + CompiledPlan — the ONE place primitive names mean code.

Each registry entry bundles the three faces of a primitive:

* ``cost``   — the analytic ``LayerCost`` the planner prices it with;
* ``setup``  — one-time per-layer preparation (pruned-FFT shape for the
  bound patch geometry, cached kernel spectra, pool mode), producing a
  ``PreparedLayer``;
* ``apply``  — the per-call forward, taking the prepared state.

``CompiledPlan`` binds a plan's per-layer primitives to ``PreparedLayer``s
once, so cached kernel spectra are computed once per plan and reused
across every patch and batch size; ``CompiledPlan.apply`` walks them
(``apply_prepared_range``), optionally fusing each ``fft_cached`` conv +
``mpf`` pool pair into one ``fft_conv_pool_fused`` call (``fuse_pairs``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..configs.base import ConvNetConfig
from ..kernels.dispatch import resolve_use_kernels
from .cost_model import (
    LayerCost,
    conv_direct_cost,
    conv_fft_cached_kernels_cost,
    conv_fft_data_parallel_cost,
    conv_fft_task_parallel_cost,
    conv_overlap_save_cost,
    mpf_cost,
    pool_cost,
)
from .direct_conv import direct_conv
from .fft_conv import (
    fft_conv_data_parallel,
    fft_conv_pool_fused,
    fft_conv_task_parallel,
    fft_conv_with_precomputed,
    precompute_kernel_fft,
)
from .mpf import max_pool3d, mpf, recombine_fragments
from .overlap_save import OverlapSaveSpec, overlap_save_conv, plan_overlap_save
from .pruned_fft import fft_optimal_shape


@dataclass(frozen=True)
class PreparedLayer:
    """One layer's prepared execution state.

    Static metadata (prim name, FFT shape, pool size) lives in the frozen
    fields; tensors (weights, biases, cached kernel spectra) live in the
    ``state`` dict.
    """

    index: int
    kind: str  # conv | pool
    prim: str  # canonical registry name
    pool_size: int = 0
    fft_shape: Optional[Tuple[int, int, int]] = None
    kernel_size: Optional[Tuple[int, int, int]] = None
    os_spec: Optional[OverlapSaveSpec] = None  # overlap_save segmentation
    fprime_chunk: Optional[int] = None  # output-channel MAD chunking
    state: Any = None


@dataclass(frozen=True)
class Primitive:
    """Registry entry: a primitive's cost model, setup, and apply together.

    * conv — ``cost(S, f, fp, n, k, geom=None)``; ``setup(w, b, n, index=...)``;
    * pool — ``cost(S, f, n, p, geom=None)``;     ``setup(p, n, index=...)``;
    * both — ``apply(prepared, x, state, use_kernels=...)``.
    """

    name: str
    kind: str  # conv | pool
    cost: Callable[..., LayerCost]
    setup: Callable[..., PreparedLayer]
    apply: Callable[..., torch.Tensor]


_CONV: Dict[str, Primitive] = {}
_POOL: Dict[str, Primitive] = {}
_CONV_ALIASES: Dict[str, str] = {}


def register_conv_primitive(prim: Primitive, *, aliases: Sequence[str] = ()) -> Primitive:
    if prim.kind != "conv":
        raise ValueError(f"{prim.name}: conv registry got kind {prim.kind!r}")
    _CONV[prim.name] = prim
    for a in aliases:
        _CONV_ALIASES[a] = prim.name
    return prim


def register_pool_primitive(prim: Primitive) -> Primitive:
    if prim.kind != "pool":
        raise ValueError(f"{prim.name}: pool registry got kind {prim.kind!r}")
    _POOL[prim.name] = prim
    return prim


def conv_primitive(name: str) -> Primitive:
    canonical = _CONV_ALIASES.get(name, name)
    try:
        return _CONV[canonical]
    except KeyError:
        raise ValueError(
            f"unknown conv primitive {name!r}; registered: {sorted(_CONV)}"
        ) from None


def pool_primitive(name: str) -> Primitive:
    try:
        return _POOL[name]
    except KeyError:
        raise ValueError(
            f"unknown pool primitive {name!r}; registered: {sorted(_POOL)}"
        ) from None


def get_primitive(name: str) -> Primitive:
    """Resolve a name in either registry (conv aliases included)."""
    canonical = _CONV_ALIASES.get(name, name)
    if canonical in _CONV:
        return _CONV[canonical]
    if canonical in _POOL:
        return _POOL[canonical]
    raise ValueError(
        f"unknown primitive {name!r}; registered: {sorted(_CONV) + sorted(_POOL)}"
    )


def registered_conv_names() -> Tuple[str, ...]:
    """Canonical conv primitive names (aliases excluded)."""
    return tuple(_CONV)


def registered_pool_names() -> Tuple[str, ...]:
    return tuple(_POOL)


def resolve_primitive(prepared: PreparedLayer) -> Primitive:
    """The registry entry a ``PreparedLayer`` executes as."""
    return (_CONV if prepared.kind == "conv" else _POOL)[prepared.prim]


# ---------------------------------------------------------------------------
# Built-in primitives
# ---------------------------------------------------------------------------


def _ksize(w: torch.Tensor) -> Tuple[int, int, int]:
    kx, ky, kz = w.shape[2:]
    return (int(kx), int(ky), int(kz))


def _setup_direct(w, b, n, *, index: int = -1) -> PreparedLayer:
    return PreparedLayer(
        index, "conv", "direct", kernel_size=_ksize(w), state={"w": w, "b": b}
    )


def _apply_direct(pl, x, state, *, use_kernels: Optional[bool] = None):
    return direct_conv(x, state["w"], state["b"], use_kernels=use_kernels)


def _setup_fft(name: str):
    def setup(w, b, n, *, index: int = -1) -> PreparedLayer:
        fft_shape = fft_optimal_shape(tuple(int(s) for s in n))
        return PreparedLayer(
            index, "conv", name,
            fft_shape=fft_shape, kernel_size=_ksize(w), state={"w": w, "b": b},
        )

    return setup


def _apply_fft_data(pl, x, state, *, use_kernels: Optional[bool] = None):
    return fft_conv_data_parallel(
        x, state["w"], state["b"], fft_shape=pl.fft_shape, use_kernels=use_kernels
    )


def _apply_fft_task(pl, x, state, *, use_kernels: Optional[bool] = None):
    return fft_conv_task_parallel(
        x, state["w"], state["b"], fft_shape=pl.fft_shape, use_kernels=use_kernels
    )


def _setup_fft_cached(
    w, b, n, *, index: int = -1, fprime_chunk: Optional[int] = None
) -> PreparedLayer:
    fft_shape = fft_optimal_shape(tuple(int(s) for s in n))
    W = precompute_kernel_fft(w, fft_shape)  # the one-time kernel transform
    return PreparedLayer(
        index, "conv", "fft_cached",
        fft_shape=fft_shape, kernel_size=_ksize(w),
        fprime_chunk=fprime_chunk, state={"W": W, "b": b},
    )


def _apply_fft_cached(pl, x, state, *, use_kernels: Optional[bool] = None):
    return fft_conv_with_precomputed(
        x, state["W"], state["b"], pl.fft_shape, pl.kernel_size,
        use_kernels=use_kernels, fprime_chunk=pl.fprime_chunk,
    )


def _setup_overlap_save(
    w, b, n, *, index: int = -1, seg_core=None, fprime_chunk: Optional[int] = None
) -> PreparedLayer:
    """Segment grid + cached kernel spectra at the SEGMENT FFT shape.

    ``seg_core`` aligns the layer's segment grid to an external stride (the
    volume executor passes the plan's patch core so x-adjacent patches
    share segment spectra).
    """
    k = _ksize(w)
    spec = plan_overlap_save(tuple(int(s) for s in n), k, seg_core)
    W = precompute_kernel_fft(w, spec.fft_shape)
    return PreparedLayer(
        index, "conv", "overlap_save",
        fft_shape=spec.fft_shape, kernel_size=k, os_spec=spec,
        fprime_chunk=fprime_chunk, state={"W": W, "b": b},
    )


def _apply_overlap_save(pl, x, state, *, use_kernels: Optional[bool] = None):
    return overlap_save_conv(
        x, state["W"], state["b"], pl.os_spec,
        use_kernels=use_kernels, fprime_chunk=pl.fprime_chunk,
    )


def _setup_mpf(p, n, *, index: int = -1) -> PreparedLayer:
    if any((int(x) + 1) % p for x in n):
        raise ValueError(f"MPF needs (n+1)%p==0, got n={tuple(n)}, p={p}")
    return PreparedLayer(index, "pool", "mpf", pool_size=int(p), state={})


def _apply_mpf(pl, x, state, *, use_kernels: Optional[bool] = None):
    return mpf(x, pl.pool_size, use_kernels=use_kernels)


def _setup_pool(p, n, *, index: int = -1) -> PreparedLayer:
    if any(int(x) % p for x in n):
        raise ValueError(f"plain pool needs n%p==0, got n={tuple(n)}, p={p}")
    return PreparedLayer(index, "pool", "pool", pool_size=int(p), state={})


def _apply_pool(pl, x, state, *, use_kernels: Optional[bool] = None):
    return max_pool3d(x, pl.pool_size)


register_conv_primitive(
    Primitive("direct", "conv", conv_direct_cost, _setup_direct, _apply_direct)
)
register_conv_primitive(
    Primitive("fft_data", "conv", conv_fft_data_parallel_cost,
              _setup_fft("fft_data"), _apply_fft_data)
)
register_conv_primitive(
    Primitive("fft_task", "conv", conv_fft_task_parallel_cost,
              _setup_fft("fft_task"), _apply_fft_task),
    aliases=("fft",),
)
register_conv_primitive(
    Primitive("fft_cached", "conv", conv_fft_cached_kernels_cost,
              _setup_fft_cached, _apply_fft_cached)
)
register_conv_primitive(
    Primitive("overlap_save", "conv", conv_overlap_save_cost,
              _setup_overlap_save, _apply_overlap_save)
)
register_pool_primitive(Primitive("mpf", "pool", mpf_cost, _setup_mpf, _apply_mpf))
register_pool_primitive(Primitive("pool", "pool", pool_cost, _setup_pool, _apply_pool))


def conv_apply(name: str, x, w, b=None, *, use_kernels: Optional[bool] = None):
    """Apply a conv primitive without retained state (setup inlined), for
    callers that cannot reuse prepared state across calls.  ``name`` may be
    an alias (e.g. ``"fft"``)."""
    prim = conv_primitive(name)
    pl = prim.setup(w, b, tuple(int(s) for s in x.shape[-3:]))
    return prim.apply(pl, x, pl.state, use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# Plan compilation: Plan -> PreparedLayers
# ---------------------------------------------------------------------------


def plan_input_size(net: ConvNetConfig, prims: Sequence[str], m: int) -> int:
    """Input size per apply call for fragment size ``m``, walked backwards."""
    n = m
    for i in reversed(range(len(net.layers))):
        layer = net.layers[i]
        if layer.kind == "conv":
            n = n + layer.size - 1
        elif prims[i] == "mpf":
            n = layer.size * n + layer.size - 1
        else:
            n = layer.size * n
    return n


def layer_fprime_chunk(fprime_chunk, i: int) -> Optional[int]:
    """Resolve a ``fprime_chunk`` for ABSOLUTE layer index ``i``: one int
    for every eligible conv, or a per-layer schedule (``None`` entries and
    positions past its end mean unchunked)."""
    if fprime_chunk is None:
        return None
    if isinstance(fprime_chunk, (tuple, list)):
        v = fprime_chunk[i] if i < len(fprime_chunk) else None
        return None if v is None else int(v)
    return int(fprime_chunk)


def prepare_layers(
    params,
    net: ConvNetConfig,
    prims: Sequence[str],
    n,
    lo: int = 0,
    hi: Optional[int] = None,
    *,
    overlap_seg: Optional[int] = None,
    fprime_chunk=None,
) -> Tuple[PreparedLayer, ...]:
    """Run each layer's one-time setup for layers [lo, hi).

    ``n`` is the spatial input extent at layer ``lo`` (int or per-axis
    tuple).  ``overlap_seg`` pins the segment core of a FIRST-layer
    ``overlap_save`` conv; ``fprime_chunk`` bounds the live output spectra
    of ``fft_cached`` and ``overlap_save`` layers.
    """
    if hi is None:
        hi = len(net.layers)
    n = tuple(int(s) for s in (n if isinstance(n, (tuple, list)) else (n,) * 3))
    prepared = []
    for i in range(lo, hi):
        layer = net.layers[i]
        if layer.kind == "conv":
            prim = conv_primitive(prims[i])
            w, b = params[i]
            fc_i = layer_fprime_chunk(fprime_chunk, i)
            if i == 0 and prim.name == "overlap_save" and overlap_seg:
                prepared.append(
                    prim.setup(
                        w, b, n, index=i, seg_core=overlap_seg, fprime_chunk=fc_i
                    )
                )
            elif prim.name in ("fft_cached", "overlap_save") and fc_i is not None:
                prepared.append(prim.setup(w, b, n, index=i, fprime_chunk=fc_i))
            else:
                prepared.append(prim.setup(w, b, n, index=i))
            n = tuple(x - layer.size + 1 for x in n)
        else:
            prim = pool_primitive(prims[i])
            prepared.append(prim.setup(layer.size, n, index=i))
            n = tuple(x // layer.size for x in n)
    return tuple(prepared)


def apply_prepared_range(
    net: ConvNetConfig,
    prepared: Sequence[PreparedLayer],
    x,
    *,
    states: Optional[Sequence[Any]] = None,
    use_kernels: Optional[bool] = None,
    fuse_pairs: bool = False,
):
    """Walk prepared layers over ``x``: the thin core of plan execution.

    ReLU follows the whole-net rule (no activation after the net's final
    conv), so chaining ranges composes to a full forward pass.  ``states``
    (when given) substitutes each layer's state dict.

    With ``fuse_pairs`` a consecutive ``fft_cached`` conv + ``mpf`` pool
    pair (not the net's last conv) runs as one ``fft_conv_pool_fused``
    call (bias on the MAD's DC bin, inverse-window crop folded into the
    pool, ReLU after the pool) instead of two primitive applies.
    """
    last_conv = max(i for i, l in enumerate(net.layers) if l.kind == "conv")
    prepared = tuple(prepared)
    states = [pl.state for pl in prepared] if states is None else list(states)
    i = 0
    while i < len(prepared):
        pl = prepared[i]
        st = states[i]
        nxt = prepared[i + 1] if i + 1 < len(prepared) else None
        if (
            fuse_pairs
            and pl.kind == "conv"
            and pl.prim == "fft_cached"
            and pl.index != last_conv  # the fused path applies the ReLU
            and nxt is not None
            and nxt.kind == "pool"
            and nxt.prim == "mpf"
            and nxt.index == pl.index + 1
        ):
            x = fft_conv_pool_fused(
                x, st["W"], st["b"],
                fft_shape=pl.fft_shape, k=pl.kernel_size, p=nxt.pool_size,
                use_kernels=use_kernels, fprime_chunk=pl.fprime_chunk,
            )
            i += 2
            continue
        x = resolve_primitive(pl).apply(pl, x, st, use_kernels=use_kernels)
        if pl.kind == "conv" and pl.index != last_conv:
            x = torch.relu(x)
        i += 1
    return x


@dataclass
class CompiledPlan:
    """A plan bound to per-layer prepared state — setup done exactly once.

    ``layers[i]`` is layer ``i``'s ``PreparedLayer``; ``states`` is the
    matching list of state dicts.  ``apply``/``apply_range`` walk the
    prepared layers.  ``use_kernels`` is the caller's tri-state, handed to
    every wrapper; ``None`` resolves per tensor.
    """

    net: ConvNetConfig
    prims: Tuple[str, ...]
    layers: Tuple[PreparedLayer, ...]
    n_in: int
    use_kernels: Optional[bool] = None
    fuse_pairs: bool = False
    plan: Optional[object] = None

    @property
    def states(self):
        return [pl.state for pl in self.layers]

    @property
    def mpf_pools(self) -> Tuple[int, ...]:
        """MPF pool sizes in network order (recombination schedule)."""
        return tuple(
            pl.pool_size for pl in self.layers
            if pl.kind == "pool" and pl.prim == "mpf"
        )

    def apply_range(self, x, lo: int = 0, hi: Optional[int] = None, *, states=None):
        if hi is None:
            hi = len(self.layers)
        if states is not None:
            states = states[lo:hi]
        return apply_prepared_range(
            self.net, self.layers[lo:hi], x,
            states=states, use_kernels=self.use_kernels,
            fuse_pairs=self.fuse_pairs,
        )

    def apply(self, x, *, states=None, recombine: bool = True):
        """Full forward over a patch batch; recombine MPF fragments if asked."""
        S = x.shape[0]
        x = self.apply_range(x, states=states)
        pools = self.mpf_pools
        if recombine and pools:
            x = recombine_fragments(x, pools, S)
        return x


def compile_plan(
    params,
    net: ConvNetConfig,
    *,
    prims: Sequence[str],
    n_in: Optional[int] = None,
    m: Optional[int] = None,
    use_kernels: Optional[bool] = None,
    fuse_pairs: Optional[bool] = None,
    fprime_chunk=None,
    plan: Optional[object] = None,
    overlap_seg: Optional[int] = None,
) -> CompiledPlan:
    """Bind primitives to prepared per-layer state for one patch geometry.

    Give either ``n_in`` or the fragment size ``m``.  ``fuse_pairs=None``
    follows ``use_kernels`` resolved against the device the weights live
    on: the fused conv+pool epilogue switches on with the kernels.
    """
    prims = tuple(prims)
    if len(prims) != len(net.layers):
        raise ValueError(f"{len(prims)} prims for {len(net.layers)} layers")
    w0 = next(p[0] for p in params if p is not None)
    resolved = resolve_use_kernels(use_kernels, w0)  # raises for True on the CPU
    if fuse_pairs is None:
        fuse_pairs = resolved
    if n_in is None:
        if m is None:
            raise ValueError("need n_in or m")
        n_in = plan_input_size(net, prims, m)
    layers = prepare_layers(
        params, net, prims, n_in,
        overlap_seg=overlap_seg, fprime_chunk=fprime_chunk,
    )
    return CompiledPlan(
        net, prims, layers, int(n_in), use_kernels, bool(fuse_pairs), plan
    )


def compile_from_plan(
    params,
    net: ConvNetConfig,
    plan,
    *,
    use_kernels: Optional[bool] = None,
    fuse_pairs: Optional[bool] = None,
    fprime_chunk=None,
) -> CompiledPlan:
    """CompiledPlan for a ``planner.Plan`` (geometry read off the plan)."""
    return compile_plan(
        params, net, prims=plan.prims, n_in=plan.n_in,
        use_kernels=use_kernels, fuse_pairs=fuse_pairs, fprime_chunk=fprime_chunk,
        plan=plan,
        overlap_seg=plan.core if plan.prims[0] == "overlap_save" else None,
    )
