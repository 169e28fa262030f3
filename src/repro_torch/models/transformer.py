"""Decoder-only LM assembled from the layer zoo: the dense family.

Layer stacking follows the reference: the pattern (length PL) repeats
R = n_layers // PL times, parameters for pattern position j are stacked
over repeats (leading dim R), and a partial trailing repeat lives under
``rem``.  Where the reference runs the repeats under ``lax.scan``, the
port runs a Python loop over views ``stacked[r]``; there is no remat,
since this is inference.

Three entry points share the block code:
  forward     — full-sequence logits
  prefill     — full-sequence logits + decode caches
  decode_step — single-token step against the caches

Caches (leading dim R, stacked like params):
  {"blocks": {j: {"k", "v": (R, B, S_max, Hkv, hd)}}, "rem": {j: {"k", "v":
  (B, S_max, Hkv, hd)}}, "lengths": (B,) int32}

``decode_step`` updates the caches IN PLACE — one new row per sequence and
layer, written into the layer's view of the stacked cache — where the
reference carries the whole cache through the scan and rewrites it with
``dynamic_update_index_in_dim``.  Only ``lengths`` is a new tensor.

Mamba and MoE blocks, frontends (VLM patches, audio) and the
encoder-decoder wait in ROADMAP.md (Queue 1, item 14) and raise here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, parse_block_token
from ..kernels.dispatch import DeviceLike, resolve_device
from ..layers import attention as attn_l
from ..layers import embedding as emb_l
from ..layers import mlp as mlp_l
from ..layers import norms as norm_l


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the reference the port does not serve yet."""
    todo = "waits in ROADMAP.md (Queue 1, item 14)"
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder {todo}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend!r} frontend {todo}")
    for tok in cfg.block_pattern:
        mixer, is_moe = parse_block_token(tok)
        if mixer == "mamba":
            raise NotImplementedError(f"{cfg.name}: the Mamba2/SSM block {todo}")
        if is_moe:
            raise NotImplementedError(f"{cfg.name}: the MoE block {todo}")


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _index(tree, r: int):
    """The r-th repeat of a stacked tree: views, no copies."""
    return _tree_map(lambda t: t[r], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(generator, cfg: ModelConfig, tok: str, device) -> Dict[str, Any]:
    dt = _dtype(cfg)
    p: Dict[str, Any] = {
        "norm1": norm_l.norm_init(cfg.norm, cfg.d_model, dt, device),
        "mixer": attn_l.attn_init(generator, cfg.d_model, cfg.attn, dt, device),
    }
    if cfg.d_ff > 0:
        p["norm2"] = norm_l.norm_init(cfg.norm, cfg.d_model, dt, device)
        p["ffn"] = mlp_l.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dt, device)
    return p


def init_params(
    generator: torch.Generator, cfg: ModelConfig, *, device: DeviceLike = None
) -> Dict[str, Any]:
    """Random params in ``cfg.dtype`` on ``device`` (``None``: the card).

    Tensor by tensor: each is drawn in f32 on the generator's device and
    cast, and each repeat's block is written into its slice of the stacked
    tensors, so no f32 copy of the model — nor of one stacked weight — is
    ever made.  Pass a CUDA generator to draw on the card.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    PL = len(cfg.block_pattern)
    R = cfg.n_layers // PL
    REM = cfg.n_layers % PL
    params: Dict[str, Any] = {
        "embed": emb_l.embed_init(generator, cfg.vocab, cfg.d_model, cfg.tie_embeddings,
                                  dt, dev),
        "final_norm": norm_l.norm_init(cfg.norm, cfg.d_model, dt, dev),
    }
    blocks: Optional[Dict[str, Any]] = None
    for r in range(R):
        rep = {str(j): _init_block(generator, cfg, tok, dev)
               for j, tok in enumerate(cfg.block_pattern)}
        if blocks is None:
            blocks = _tree_map(lambda t: torch.empty((R,) + tuple(t.shape), dtype=t.dtype,
                                                     device=dev), rep)
        _copy_into(_index(blocks, r), rep)
    params["blocks"] = blocks
    if REM:
        params["rem"] = {
            str(j): _init_block(generator, cfg, cfg.block_pattern[j], dev) for j in range(REM)
        }
    return params


def _copy_into(dst, src) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def params_from_numpy(params, cfg: ModelConfig, device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's params as numpy arrays (the same nested dict) ->
    the port's tensors in ``cfg.dtype`` on ``device`` (``None``: the card),
    key for key."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    return _tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(device=dev, dtype=dt),
        params,
    )


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _window(cfg: ModelConfig, tok: str) -> Optional[int]:
    mixer, _ = parse_block_token(tok)
    return cfg.attn.swa_window if mixer == "local" else None


def _ffn(p, x, cfg: ModelConfig):
    if cfg.d_ff > 0:
        h = norm_l.norm_apply(cfg.norm, x, p["norm2"])
        x = x + mlp_l.mlp_apply(p["ffn"], h, cfg.act)
    return x


def _block_full(p, x, tok: str, cfg: ModelConfig, positions) -> torch.Tensor:
    """Full-sequence block (forward, without cache capture)."""
    h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
    x = x + attn_l.attn_apply(p["mixer"], h, cfg.attn, positions, window=_window(cfg, tok))
    return _ffn(p, x, cfg)


def _block_prefill(p, x, tok: str, cfg: ModelConfig, positions, cache_len: int):
    h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
    y, (k, v) = attn_l.attn_prefill(
        p["mixer"], h, cfg.attn, positions, cache_len, window=_window(cfg, tok)
    )
    return _ffn(p, x + y, cfg), {"k": k, "v": v}


def _block_decode(p, x, tok: str, cfg: ModelConfig, cache, lengths, use_kernels):
    """One block of a decode step; writes this layer's cache in place."""
    h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
    y, _ = attn_l.attn_decode(
        p["mixer"], h, cfg.attn, cache["k"], cache["v"], lengths,
        window=_window(cfg, tok), use_kernels=use_kernels,
    )
    return _ffn(p, x + y, cfg)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Text-only embedding and (B, S) positions."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = emb_l.embed_apply(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return x, positions


def _layers(params, cfg: ModelConfig):
    """(block params, token, (repeat or None for ``rem``, pattern key)) in
    layer order; stacked params come as views of their repeat."""
    PL = len(cfg.block_pattern)
    for r in range(cfg.n_layers // PL):
        for j, tok in enumerate(cfg.block_pattern):
            yield _index(params["blocks"][str(j)], r), tok, (r, str(j))
    for j in range(cfg.n_layers % PL):
        yield params["rem"][str(j)], cfg.block_pattern[j], (None, str(j))


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Full-sequence logits (B, S, vocab) + the MoE aux loss (0 here)."""
    x, positions = _embed_inputs(params, cfg, batch)
    for p, tok, _ in _layers(params, cfg):
        x = _block_full(p, x, tok, cfg, positions)
    x = norm_l.norm_apply(cfg.norm, x, params["final_norm"])
    logits = emb_l.head_apply(params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *, cache_len: int):
    """Logits + decode caches (stacked over repeats)."""
    x, positions = _embed_inputs(params, cfg, batch)
    per_repeat: Dict[str, list] = {}
    rem: Dict[str, Any] = {}
    for p, tok, (r, j) in _layers(params, cfg):
        x, cache = _block_prefill(p, x, tok, cfg, positions, cache_len)
        if r is None:
            rem[j] = cache
        else:
            per_repeat.setdefault(j, []).append(cache)
    blocks = {
        j: {key: torch.stack([c[key] for c in cs]) for key in cs[0]}
        for j, cs in per_repeat.items()
    }
    x = norm_l.norm_apply(cfg.norm, x, params["final_norm"])
    logits = emb_l.head_apply(params["embed"], x)
    B, S = batch["tokens"].shape
    lengths = torch.full((B,), S, dtype=torch.int32, device=logits.device)
    return logits, {"blocks": blocks, "rem": rem, "lengths": lengths}


def decode_step(params, cfg: ModelConfig, tokens, caches, *,
                use_kernels: Optional[bool] = None):
    """tokens (B, 1) -> logits (B, 1, vocab) + caches.

    The caches' K/V tensors are updated in place (see the module
    docstring) and returned; ``lengths`` comes back as a new tensor,
    ``lengths + 1``.  ``use_kernels`` follows the port's dispatch rule
    (``None``: the CUDA decode-attention kernel on the card).
    """
    lengths = caches["lengths"]
    x = emb_l.embed_apply(params["embed"], tokens)
    for p, tok, (r, j) in _layers(params, cfg):
        cache = caches["rem"][j] if r is None else _index(caches["blocks"][j], r)
        x = _block_decode(p, x, tok, cfg, cache, lengths, use_kernels)
    x = norm_l.norm_apply(cfg.norm, x, params["final_norm"])
    logits = emb_l.head_apply(params["embed"], x)
    return logits, {"blocks": caches["blocks"], "rem": caches["rem"], "lengths": lengths + 1}


# ---------------------------------------------------------------------------
# Cache constructor
# ---------------------------------------------------------------------------


def make_caches(cfg: ModelConfig, B: int, S_max: int, *, device: DeviceLike = None):
    """Zero caches matching prefill's output layout, on ``device``
    (``None``: the card).  The reference's ``abstract=True`` variant
    (shape stand-ins for its dry run) waits with the dry run."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    a = cfg.attn
    PL = len(cfg.block_pattern)
    R = cfg.n_layers // PL

    def kv(lead):
        shape = lead + (B, S_max, a.n_kv_heads, a.head_dim)
        return {key: torch.zeros(shape, dtype=dt, device=dev) for key in ("k", "v")}

    return {
        "blocks": {str(j): kv((R,)) for j in range(PL)},
        "rem": {str(j): kv(()) for j in range(cfg.n_layers % PL)},
        "lengths": torch.zeros((B,), dtype=torch.int32, device=dev),
    }
