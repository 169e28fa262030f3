"""Whisper-style encoder-decoder (audio family).

Encoder: ``n_enc_layers`` bidirectional attention blocks over precomputed
frame embeddings (the conv frontend is a stub, ``layers/stubs.py``) with
sinusoidal positions.  Decoder: causal self-attention + cross-attention to
the encoder output + MLP, with sinusoidal positions on token embeddings.

The blocks are stacked as the reference's ``jax.vmap`` init stacks them:
``enc_blocks``/``dec_blocks`` hold each leaf with a leading layer dim,
and the port loops over views ``stacked[l]`` where the reference scans.

Caches: ``{"dec": {"k", "v": (L, B, S_max, Hkv, hd), "xk", "xv": (L, B,
enc_seq, Hkv, hd)}, "lengths": (B,)}``: the self-attention KV of each
decoder layer, and the cross-attention KV computed once at prefill from
the encoder output and left as it is by decode.  ``decode_step`` writes
each layer's new self-attention row IN PLACE through ``attn_decode`` (the
``decode_attn`` kernel on the card), where the reference rewrites the
stacked cache with ``dynamic_update_index_in_dim``; only ``lengths`` is a
new tensor.  Cross-attention is ``chunked_attention`` (plain PyTorch), as
the reference's is plain XLA.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.dispatch import DeviceLike, resolve_device
from ..layers import attention as attn_l
from ..layers import embedding as emb_l
from ..layers import mlp as mlp_l
from ..layers import norms as norm_l
from ..layers.attention import chunked_attention
from ..layers.dot import contract
# the reference's params (numpy, the stacked blocks included) -> tensors,
# leaf for leaf: the transformer's conversion, which walks any nested dict
from .transformer import _copy_into, _dtype, _index, _tree_map, params_from_numpy  # noqa: F401


def _init_enc_block(generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    dt = _dtype(cfg)
    return {
        "norm1": norm_l.norm_init(cfg.norm, cfg.d_model, dt, device),
        "attn": attn_l.attn_init(generator, cfg.d_model, cfg.attn, dt, device),
        "norm2": norm_l.norm_init(cfg.norm, cfg.d_model, dt, device),
        "mlp": mlp_l.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dt, device),
    }


def _init_dec_block(generator, cfg: ModelConfig, device) -> Dict[str, Any]:
    dt = _dtype(cfg)
    return {
        "norm1": norm_l.norm_init(cfg.norm, cfg.d_model, dt, device),
        "self": attn_l.attn_init(generator, cfg.d_model, cfg.attn, dt, device),
        "norm_x": norm_l.norm_init(cfg.norm, cfg.d_model, dt, device),
        "cross": attn_l.attn_init(generator, cfg.d_model, cfg.attn, dt, device),
        "norm2": norm_l.norm_init(cfg.norm, cfg.d_model, dt, device),
        "mlp": mlp_l.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dt, device),
    }


def _stacked(init_one, n: int, device) -> Dict[str, Any]:
    """``n`` blocks drawn one at a time, each written into its layer's
    slice of the stacked tensors as soon as it is drawn."""
    stack = None
    for i in range(n):
        block = init_one()
        if stack is None:
            stack = _tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                                    device=device), block)
        _copy_into(_index(stack, i), block)
    return stack


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random params in ``cfg.dtype`` on ``device`` (``None``: the card),
    in the reference's layout; pass a CUDA generator to draw on the card."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    return {
        "embed": emb_l.embed_init(generator, cfg.vocab, cfg.d_model, cfg.tie_embeddings,
                                  dt, dev),
        "enc_blocks": _stacked(lambda: _init_enc_block(generator, cfg, dev),
                               cfg.n_enc_layers, dev),
        "enc_norm": norm_l.norm_init(cfg.norm, cfg.d_model, dt, dev),
        "dec_blocks": _stacked(lambda: _init_dec_block(generator, cfg, dev),
                               cfg.n_layers, dev),
        "final_norm": norm_l.norm_init(cfg.norm, cfg.d_model, dt, dev),
    }


# ---------------------------------------------------------------------------


def _cross_kv(p, enc_out, cfg: ModelConfig):
    k = contract("bsd,dhk->bshk", enc_out, p["wk"])
    v = contract("bsd,dhk->bshk", enc_out, p["wv"])
    if cfg.attn.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _cross_attend(p, x, k, v, cfg: ModelConfig):
    q = contract("bsd,dhk->bshk", x, p["wq"])
    if cfg.attn.qkv_bias:
        q = q + p["bq"]
    o = chunked_attention(q, k, v, causal=False)
    return contract("bshk,hkd->bsd", o, p["wo"])


def _positions(S: int, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The (S, d_model) sinusoidal table in the activations' dtype."""
    return emb_l.sinusoidal_positions(S, cfg.d_model, device=x.device).to(x.dtype)


def _enc_block(p, x, cfg: ModelConfig, positions):
    h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
    q, k, v = attn_l._qkv(p["attn"], h, cfg.attn, positions, rope=False)
    o = chunked_attention(q, k, v, causal=False)
    x = x + contract("bshk,hkd->bsd", o, p["attn"]["wo"])
    h = norm_l.norm_apply(cfg.norm, x, p["norm2"])
    return x + mlp_l.mlp_apply(p["mlp"], h, cfg.act)


def encode(params, cfg: ModelConfig, frame_embeds: torch.Tensor) -> torch.Tensor:
    """frame_embeds (B, enc_seq, d_model) -> encoder output."""
    B, S = frame_embeds.shape[:2]
    x = frame_embeds + _positions(S, cfg, frame_embeds)[None]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for i in range(cfg.n_enc_layers):
        x = _enc_block(_index(params["enc_blocks"], i), x, cfg, positions)
    return norm_l.norm_apply(cfg.norm, x, params["enc_norm"])


def _embed_tokens(params, cfg: ModelConfig, tokens):
    B, S = tokens.shape
    x = emb_l.embed_apply(params["embed"], tokens)
    x = x + _positions(S, cfg, x)[None]
    return x, torch.arange(S, device=x.device)[None].expand(B, S)


def _dec_block(p, x, enc_out, cfg: ModelConfig, positions):
    """One decoder block over a whole sequence: (x, (k, v, xk, xv))."""
    h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
    q, k, v = attn_l._qkv(p["self"], h, cfg.attn, positions, rope=False)
    o = chunked_attention(q, k, v, causal=True)
    x = x + contract("bshk,hkd->bsd", o, p["self"]["wo"])
    h = norm_l.norm_apply(cfg.norm, x, p["norm_x"])
    kx, vx = _cross_kv(p["cross"], enc_out, cfg)
    x = x + _cross_attend(p["cross"], h, kx, vx, cfg)
    h = norm_l.norm_apply(cfg.norm, x, p["norm2"])
    return x + mlp_l.mlp_apply(p["mlp"], h, cfg.act), (k, v, kx, vx)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *, remat: bool = True):
    """batch {tokens (B, S), frame_embeds (B, enc_seq, d)} -> (logits, 0).
    With ``remat`` and autograd recording, each decoder block is
    recomputed in the backward, as the reference's ``jax.checkpoint``."""
    enc_out = encode(params, cfg, batch["frame_embeds"])
    x, positions = _embed_tokens(params, cfg, batch["tokens"])
    recompute = remat and torch.is_grad_enabled()

    def body(p, x):
        return _dec_block(p, x, enc_out, cfg, positions)[0]

    for i in range(cfg.n_layers):
        p = _index(params["dec_blocks"], i)
        x = checkpoint(body, p, x, use_reentrant=False) if recompute else body(p, x)
    x = norm_l.norm_apply(cfg.norm, x, params["final_norm"])
    return (emb_l.head_apply(params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *, cache_len: int):
    """Logits + caches: the self-attention K/V zero-padded to ``cache_len``
    and the cross-attention K/V of the encoder output, stacked over
    layers."""
    enc_out = encode(params, cfg, batch["frame_embeds"])
    x, positions = _embed_tokens(params, cfg, batch["tokens"])
    B, S = batch["tokens"].shape
    if S > cache_len:
        raise ValueError(f"prompt of {S} tokens exceeds the cache length {cache_len}")
    per_layer = []
    for i in range(cfg.n_layers):
        x, (k, v, kx, vx) = _dec_block(_index(params["dec_blocks"], i), x, enc_out, cfg,
                                       positions)
        ck = k.new_zeros((B, cache_len) + tuple(k.shape[2:]))
        cv = v.new_zeros((B, cache_len) + tuple(v.shape[2:]))
        ck[:, :S] = k
        cv[:, :S] = v
        per_layer.append({"k": ck, "v": cv, "xk": kx, "xv": vx})
    dec = {key: torch.stack([c[key] for c in per_layer]) for key in ("k", "v", "xk", "xv")}
    x = norm_l.norm_apply(cfg.norm, x, params["final_norm"])
    logits = emb_l.head_apply(params["embed"], x)
    lengths = torch.full((B,), S, dtype=torch.int32, device=logits.device)
    return logits, {"dec": dec, "lengths": lengths}


def decode_step(params, cfg: ModelConfig, tokens, caches, *,
                use_kernels: Optional[bool] = None):
    """tokens (B, 1) -> logits (B, 1, vocab) + caches (self-attention rows
    written in place, ``lengths + 1`` a new tensor).

    The token's position embedding is the table's row ``lengths``, clamped
    to ``S_max - 1`` as JAX clamps an out-of-range gather (a slot past its
    cache reads the last row)."""
    lengths = caches["lengths"]
    dec = caches["dec"]
    x = emb_l.embed_apply(params["embed"], tokens)
    S_max = dec["k"].shape[2]
    table = _positions(S_max, cfg, x)
    x = x + table[lengths.long().clamp(0, S_max - 1)][:, None]
    for i in range(cfg.n_layers):
        p = _index(params["dec_blocks"], i)
        c = _index(dec, i)
        h = norm_l.norm_apply(cfg.norm, x, p["norm1"])
        y, _ = attn_l.attn_decode(p["self"], h, cfg.attn, c["k"], c["v"], lengths,
                                  use_kernels=use_kernels)
        x = x + y
        h = norm_l.norm_apply(cfg.norm, x, p["norm_x"])
        x = x + _cross_attend(p["cross"], h, c["xk"], c["xv"], cfg)
        h = norm_l.norm_apply(cfg.norm, x, p["norm2"])
        x = x + mlp_l.mlp_apply(p["mlp"], h, cfg.act)
    x = norm_l.norm_apply(cfg.norm, x, params["final_norm"])
    return emb_l.head_apply(params["embed"], x), {"dec": dec, "lengths": lengths + 1}


def make_caches(cfg: ModelConfig, B: int, S_max: int, *, device: DeviceLike = None):
    """Zero caches matching prefill's output layout, on ``device``
    (``None``: the card); ``device="meta"`` gives the shape stand-ins of
    the reference's ``abstract=True``."""
    dev = resolve_device(device)
    a = cfg.attn
    L = cfg.n_layers
    dt = _dtype(cfg)

    def zeros(S):
        return torch.zeros((L, B, S, a.n_kv_heads, a.head_dim), dtype=dt, device=dev)

    return {"dec": {"k": zeros(S_max), "v": zeros(S_max), "xk": zeros(cfg.enc_seq),
                    "xv": zeros(cfg.enc_seq)},
            "lengths": torch.zeros((B,), dtype=torch.int32, device=dev)}
