"""Decoder-only LM assembled from the layer zoo, covering the dense, MoE,
SSM and hybrid families through the config's ``block_pattern``.

Layer stacking follows the reference: the pattern (length PL) repeats
R = n_layers // PL times, parameters for pattern position j are stacked
over repeats (leading dim R), and a partial trailing repeat (gemma3's
62 = 10·6 + 2) lives under ``rem``.  Where the reference runs the
repeats under ``lax.scan``, the port runs a Python loop over views
``stacked[r]``.  ``forward(remat=True)`` recomputes each block in the
backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint``; it changes no number.

Three entry points share the block code:
  forward     — full-sequence logits + the MoE aux loss
  prefill     — full-sequence logits + decode caches
  decode_step — single-token step against the caches

A ``frontend="patch"`` config (qwen2-vl) splices ``batch["patch_embeds"]``
over the first positions and rotates with M-RoPE ids on the stub's
(t, h, w) grid (``layers/stubs.py``); without patch embeddings its
positions are text positions.

Caches (leading dim R, stacked like params; ``rem`` without it):
  attn/local/global: {"k", "v": (R, B, S_max, Hkv, hd)}
  mamba:             {"conv": (R, B, d_conv-1, ch), "state": (R, B, h, p, n) f32}
  plus "lengths": (B,) int32.

``decode_step`` updates the caches IN PLACE — one new K/V row per
sequence and attention layer, and each Mamba layer's conv window and
state, written into the layer's view of the stacked cache — where the
reference carries the whole cache through the scan and rewrites it with
``dynamic_update_index_in_dim``.  Only ``lengths`` is a new tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, parse_block_token
from ..kernels.dispatch import DeviceLike, resolve_device
from ..layers import attention as attn_l
from ..layers import embedding as emb_l
from ..layers import mlp as mlp_l
from ..layers import moe as moe_l
from ..layers import norms as norm_l
from ..layers import ssm as ssm_l
from ..layers import stubs


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _index(tree, r: int):
    """The r-th repeat of a stacked tree: views, no copies."""
    return _tree_map(lambda t: t[r], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(generator, cfg: ModelConfig, tok: str, device) -> Dict[str, Any]:
    mixer, is_moe = parse_block_token(tok)
    dt = _dtype(cfg)
    p: Dict[str, Any] = {"norm1": norm_l.norm_init(cfg.norm, cfg.d_model, dt, device)}
    if mixer == "mamba":
        p["mixer"] = ssm_l.ssm_init(generator, cfg.d_model, cfg.ssm, dt, device)
    else:
        p["mixer"] = attn_l.attn_init(generator, cfg.d_model, cfg.attn, dt, device)
    if cfg.d_ff > 0:
        p["norm2"] = norm_l.norm_init(cfg.norm, cfg.d_model, dt, device)
        if is_moe:
            p["ffn"] = moe_l.moe_init(generator, cfg.d_model, cfg.d_ff, cfg.moe, cfg.act,
                                      dt, device)
        else:
            p["ffn"] = mlp_l.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dt, device)
    return p


def init_params(
    generator: torch.Generator, cfg: ModelConfig, *, device: DeviceLike = None
) -> Dict[str, Any]:
    """Random params in ``cfg.dtype`` on ``device`` (``None``: the card).

    Tensor by tensor: each is drawn in f32 on the generator's device and
    cast, and each layer is written into its repeat's slice of the stacked
    tensors as soon as it is drawn, so beside the model no more than one
    layer and one f32 tensor are held — no f32 copy of the model, nor of
    one stacked weight.  Pass a CUDA generator to draw on the card.
    """
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
    blocks: Optional[Dict[str, Any]] = {} if R else None
    for r in range(R):
        for j, tok in enumerate(cfg.block_pattern):
            layer = _init_block(generator, cfg, tok, dev)
            if r == 0:
                blocks[str(j)] = _tree_map(lambda t: torch.empty(
                    (R,) + tuple(t.shape), dtype=t.dtype, device=dev), layer)
            _copy_into(_index(blocks[str(j)], r), layer)
            del layer
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


# leaves the reference keeps in f32 whatever the model's dtype
F32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"})


def params_from_numpy(params, cfg: ModelConfig, device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's params as numpy arrays (the same nested dict) ->
    the port's tensors on ``device`` (``None``: the card), key for key: in
    ``cfg.dtype``, except the leaves the reference keeps in f32."""
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def conv(tree):
        return {
            k: conv(v) if isinstance(v, dict) else torch.from_numpy(
                np.asarray(v, np.float32).copy()).to(
                    device=dev, dtype=torch.float32 if k in F32_LEAVES else dt)
            for k, v in tree.items()
        }

    return conv(params)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _window(cfg: ModelConfig, tok: str) -> Optional[int]:
    mixer, _ = parse_block_token(tok)
    return cfg.attn.swa_window if mixer == "local" else None


def _ffn(p, x, tok: str, cfg: ModelConfig):
    """The block's FFN half: (x, the MoE aux loss or None)."""
    if cfg.d_ff <= 0:
        return x, None
    h = norm_l.norm_apply(cfg.norm, x, p["norm2"])
    if parse_block_token(tok)[1]:
        y, aux = moe_l.moe_apply(p["ffn"], h, cfg.moe, cfg.act,
                                 routing_groups=cfg.moe_routing_groups)
        return x + y, aux
    return x + mlp_l.mlp_apply(p["ffn"], h, cfg.act), None


def _block_full(p, x, tok: str, cfg: ModelConfig, positions):
    """Full-sequence block (forward, without cache capture): (x, aux)."""
    h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
    if parse_block_token(tok)[0] == "mamba":
        y = ssm_l.ssm_apply(p["mixer"], h, cfg.ssm, cfg.d_model)
    else:
        y = attn_l.attn_apply(p["mixer"], h, cfg.attn, positions, window=_window(cfg, tok))
    return _ffn(p, x + y, tok, cfg)


def _block_prefill(p, x, tok: str, cfg: ModelConfig, positions, cache_len: int):
    h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
    if parse_block_token(tok)[0] == "mamba":
        y, (conv, state) = ssm_l.ssm_prefill(p["mixer"], h, cfg.ssm, cfg.d_model)
        cache = {"conv": conv, "state": state}
    else:
        y, (k, v) = attn_l.attn_prefill(
            p["mixer"], h, cfg.attn, positions, cache_len, window=_window(cfg, tok)
        )
        cache = {"k": k, "v": v}
    return _ffn(p, x + y, tok, cfg)[0], cache


def _block_decode(p, x, tok: str, cfg: ModelConfig, cache, lengths, use_kernels):
    """One block of a decode step; writes this layer's cache in place."""
    h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
    if parse_block_token(tok)[0] == "mamba":
        y, _ = ssm_l.ssm_decode(p["mixer"], h, cfg.ssm, cfg.d_model, cache["conv"],
                                cache["state"])
    else:
        y, _ = attn_l.attn_decode(
            p["mixer"], h, cfg.attn, cache["k"], cache["v"], lengths,
            window=_window(cfg, tok), use_kernels=use_kernels,
        )
    return _ffn(p, x + y, tok, cfg)[0]


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """The embedded inputs and their positions: (B, S) text positions, or
    (3, B, S) M-RoPE ids where patch embeddings are spliced in."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = emb_l.embed_apply(params["embed"], tokens)
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        x = stubs.vlm_splice(x, batch["patch_embeds"])
        positions = stubs.vlm_mrope_positions(B, S, batch["patch_embeds"].shape[1],
                                              device=tokens.device)
    else:
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


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *, remat: bool = True):
    """Full-sequence logits (B, S, vocab) + the MoE aux loss (summed over
    the MoE blocks; 0 without them).  With ``remat`` and autograd
    recording, each block's activations are recomputed in the backward
    instead of kept."""
    x, positions = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    recompute = remat and torch.is_grad_enabled()
    for p, tok, _ in _layers(params, cfg):
        if recompute:
            x, a = checkpoint(_block_full, p, x, tok, cfg, positions, use_reentrant=False)
        else:
            x, a = _block_full(p, x, tok, cfg, positions)
        if a is not None:
            aux = aux + a
    x = norm_l.norm_apply(cfg.norm, x, params["final_norm"])
    logits = emb_l.head_apply(params["embed"], x)
    return logits, aux


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

    The caches' tensors are updated in place (see the module
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


def _cache_shape_for(cfg: ModelConfig, tok: str, B: int, S_max: int):
    """{key: (shape, dtype)} of one layer's decode cache."""
    dt = _dtype(cfg)
    if parse_block_token(tok)[0] == "mamba":
        s = cfg.ssm
        ch = s.d_inner(cfg.d_model) + 2 * s.d_state
        return {
            "conv": ((B, s.d_conv - 1, ch), dt),
            "state": ((B, s.n_ssm_heads(cfg.d_model), s.headdim, s.d_state), torch.float32),
        }
    a = cfg.attn
    return {
        "k": ((B, S_max, a.n_kv_heads, a.head_dim), dt),
        "v": ((B, S_max, a.n_kv_heads, a.head_dim), dt),
    }


def make_caches(cfg: ModelConfig, B: int, S_max: int, *, device: DeviceLike = None):
    """Zero caches matching prefill's output layout, on ``device``
    (``None``: the card).  The reference's ``abstract=True`` variant
    (shape stand-ins for its dry run) waits with the dry run."""
    dev = resolve_device(device)
    PL = len(cfg.block_pattern)
    R = cfg.n_layers // PL

    def zeros(tok, lead):
        return {key: torch.zeros(lead + shape, dtype=dt, device=dev)
                for key, (shape, dt) in _cache_shape_for(cfg, tok, B, S_max).items()}

    return {
        "blocks": {str(j): zeros(tok, (R,)) for j, tok in enumerate(cfg.block_pattern)},
        "rem": {str(j): zeros(cfg.block_pattern[j], ()) for j in range(cfg.n_layers % PL)},
        "lengths": torch.zeros((B,), dtype=torch.int32, device=dev),
    }
