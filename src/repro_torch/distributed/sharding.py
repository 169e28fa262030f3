"""Name-based sharding rules per (arch × shape-kind), the reference's
``repro.distributed.sharding`` rule for rule.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
The pod axis is pure data parallelism; "model" carries tensor/expert
parallelism; "data" carries batch + ZeRO-style parameter/optimizer
sharding for training.

Rules are matched on parameter *path names* (``blocks/1/ffn/w_in``,
``mixer/wq``, ``embed/tok``: the keys of the port's parameter and cache
trees, which are the reference's leaf for leaf) and trailing-dimension
shapes, so they survive the stacked (R, ...) leading dim automatically:

  attention  — shard heads over `model` when divisible; else q-heads only
               (KV replicated); else replicate attention and let the MLP
               carry the model axis (qwen1.5's 20 MHA heads, phi3's 40).
  MLP        — d_ff over `model`.
  MoE        — experts over `model` when divisible (jamba 16e), else
               tensor-parallel d_ff inside each expert (mixtral/grok 8e).
  Mamba2     — d_inner / ssm-head dims over `model`.
  embeddings — vocab over `model` when divisible, else d_model.
  ZeRO       — in train mode, every parameter leaf ≥ 2^16 elements gets one
               extra `data`-axis sharding on its largest free divisible dim.

KV caches (decode): batch over (pod, data) when divisible; the *sequence*
dim shards over `model`.  long_500k (batch=1) shards sequence over every
available axis.

The port runs on one card and places nothing by these rules: the dry run
(``launch/dryrun.py``) reads them to size each device's share
(``shard_shape``), and ``restore_with_remesh`` places a tree on a
one-device mesh.  ``P`` and ``NamedSharding`` are plain records of
JAX's ``PartitionSpec`` and ``NamedSharding``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..launch.mesh import Mesh

ZERO_MIN_ELEMS = 1 << 16


class P(tuple):
    """``PartitionSpec``: one entry per dim, each None, an axis name or a
    tuple of axis names; a one-name tuple is stored as the name, as JAX
    stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: P


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.sizes.get(name, 1)


def _batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _tree_map_with_path(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``jax.tree_util.tree_map_with_path`` over nested dicts, lists and
    tuples of tensors; ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def shard_shape(shape: Tuple[int, ...], sharding: NamedSharding) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``sharding``:
    each dim split over the product of its axes (rounded up, as JAX pads
    an uneven split)."""
    sizes = sharding.mesh.sizes
    out = []
    for i, n in enumerate(shape):
        e = sharding.spec[i] if i < len(sharding.spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        out.append(-(-n // math.prod(sizes.get(a, 1) for a in axes)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _base_param_spec(path: str, shape: Tuple[int, ...], cfg: ModelConfig, tp: int):
    """PartitionSpec entries for the TRAILING dims (caller pads the front)."""
    nd = len(shape)

    def spec(*trailing):
        return [None] * (nd - len(trailing)) + list(trailing)

    leaf = path.rsplit("/", 1)[-1]
    a = cfg.attn

    # --- small / replicated leaves
    if leaf in ("scale", "bias", "A_log", "D", "dt_bias", "conv_bx", "conv_bB",
                "conv_bC", "b_out", "router", "conv_B", "conv_C"):
        return spec()

    # --- embeddings
    if path.endswith("embed/tok"):
        V, d = shape[-2], shape[-1]
        if V % tp == 0:
            return spec("model", None)
        return spec(None, "model") if d % tp == 0 else spec()
    if path.endswith("embed/head"):
        d, V = shape[-2], shape[-1]
        if V % tp == 0:
            return spec(None, "model")
        return spec("model", None) if d % tp == 0 else spec()

    # --- MoE experts (E, d, ff) / (E, ff, d)
    if "ffn" in path and leaf in ("w_in", "w_gate", "w_out") and nd >= 3 and cfg.moe:
        E = cfg.moe.n_experts
        if shape[-3] == E:
            if E % tp == 0:
                return spec("model", None, None)
            if leaf == "w_out":
                return spec(None, "model", None)  # (E, ff, d): shard ff
            return spec(None, None, "model")  # (E, d, ff): shard ff
    # --- dense MLP
    if leaf in ("w_in", "w_gate"):
        return spec(None, "model")
    if leaf == "w_out" and "mixer" not in path:
        return spec("model", None)
    if leaf == "b_in":
        return spec("model")

    # --- attention projections
    if leaf == "wq":
        return spec(None, "model", None) if a and a.n_heads_eff % tp == 0 else spec()
    if leaf in ("wk", "wv"):
        return spec(None, "model", None) if a and a.n_kv_heads % tp == 0 else spec()
    if leaf == "wo":
        return spec("model", None, None) if a and a.n_heads_eff % tp == 0 else spec()
    if leaf == "bq":
        return spec("model", None) if a and a.n_heads_eff % tp == 0 else spec()
    if leaf in ("bk", "bv"):
        return spec("model", None) if a and a.n_kv_heads % tp == 0 else spec()

    # --- Mamba2 projections (stored unfused so they shard cleanly)
    if leaf in ("w_z", "w_x"):
        return spec(None, "model")
    if leaf in ("w_B", "w_C", "w_dt"):
        return spec(None, "model") if shape[-1] % tp == 0 else spec()
    if leaf == "conv_x":
        return spec(None, "model")
    if leaf == "norm_scale":
        return spec("model")
    if leaf == "w_out":  # ssm out proj (di, d)
        return spec("model", None)

    return spec()


def _add_zero(entries, shape, dp: int, tp: int):
    """Add one `data`-axis sharding on the largest free divisible dim."""
    best, best_idx = 0, -1
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % dp == 0 and s > best:
            best, best_idx = s, i
    if best_idx >= 0:
        entries = list(entries)
        entries[best_idx] = "data"
    return entries


def param_shardings(cfg: ModelConfig, params_tree: Any, mesh: Mesh, *,
                    zero: bool = False) -> Any:
    """Tree of NamedShardings matching ``params_tree`` (any tensors, meta
    included: only shapes are read)."""
    tp = _axis_size(mesh, "model")
    dp = _axis_size(mesh, "data")

    def one(path, leaf):
        shape = tuple(leaf.shape)
        entries = _base_param_spec(path, shape, cfg, tp)
        if zero and math.prod(shape) >= ZERO_MIN_ELEMS:
            entries = _add_zero(entries, shape, dp, tp)
        return NamedSharding(mesh, P(*entries))

    return _tree_map_with_path(one, params_tree)


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, batch_tree: Any) -> Any:
    """Shardings for the non-parameter step inputs from ``input_specs()``."""
    baxes = _batch_axes(mesh)
    bsz = math.prod(_axis_size(mesh, a) for a in baxes)
    tp = _axis_size(mesh, "model")
    B = shape.global_batch
    b_shardable = B % bsz == 0

    def cache_spec(path: str, leaf) -> NamedSharding:
        s = tuple(leaf.shape)
        leafname = path.rsplit("/", 1)[-1]
        nd = len(s)
        if leafname == "lengths":
            return NamedSharding(mesh, P())
        if leafname in ("k", "v", "xk", "xv"):
            # (..., B, S, Hkv, hd) — stacked caches have a leading R/L dim,
            # partial-repeat ("rem") caches do not.
            ent = [None] * nd
            iB, iS = nd - 4, nd - 3
            seq = s[iS]
            if b_shardable:
                ent[iB] = baxes
                ent[iS] = "model" if seq % tp == 0 else None
            else:
                rest = baxes + ("model",)
                n_rest = math.prod(_axis_size(mesh, a) for a in rest)
                ent[iS] = rest if seq % n_rest == 0 else None
            return NamedSharding(mesh, P(*ent))
        if leafname == "conv":
            # (..., B, d_conv-1, ch)
            ent = [None] * nd
            if b_shardable:
                ent[nd - 3] = baxes
            return NamedSharding(mesh, P(*ent))
        if leafname == "state":
            # (..., B, h, p, n)
            ent = [None] * nd
            if b_shardable:
                ent[nd - 4] = baxes
            if s[nd - 3] % tp == 0:
                ent[nd - 3] = "model"
            return NamedSharding(mesh, P(*ent))
        return NamedSharding(mesh, P())

    def one(path, leaf):
        if path.startswith("caches"):
            return cache_spec(path, leaf)
        s = tuple(leaf.shape)
        ent = [None] * len(s)
        if s and s[0] == B and b_shardable:
            ent[0] = baxes
        return NamedSharding(mesh, P(*ent))

    return _tree_map_with_path(one, batch_tree)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
