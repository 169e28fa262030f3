"""GQA attention: q-chunked full-sequence path + cached decode path.

Training/prefill attention is the reference's query-chunked formulation,
a Python loop over query blocks (``lax.map`` there) with an f32 softmax,
memory bounded by (q_chunk × S) score tiles.  Sliding-window (`window`)
masks |i-j| >= window.

Decode takes one query token against a (B, S_max, Hkv, d) cache and
dispatches through ``repro_torch.kernels.decode_attn``: the hand-written
CUDA kernel on a CUDA tensor, its plain version on the CPU.  The
reference's serving path never reaches its own Pallas kernel
(``use_pallas`` defaults to False down to ``attn_decode``); the port
follows its one dispatch rule (``use_kernels=None``: the kernel on the
card), which computes the same function.

Shapes: x (B, S, d_model); heads grouped contiguously (H = Hkv·G with
query head h served by kv head h // G).

The reference's sharding annotations (``distributed.constraints.constrain``)
are no-ops on one device and are dropped here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import AttnConfig
from ..kernels.decode_attn import ops as da_ops
from .dot import contract
from .embedding import _normal
from .rope import apply_mrope, apply_rope, text_mrope_positions

NEG_INF = -1e30


def attn_init(generator, d_model: int, a: AttnConfig, dtype, device) -> dict:
    s = (2.0 / d_model) ** 0.5
    so = (2.0 / (a.n_heads * a.head_dim)) ** 0.5
    G = a.q_per_kv
    Gp = a.n_heads_eff // a.n_kv_heads
    H = a.n_heads_eff
    wq = torch.zeros((d_model, a.n_kv_heads, Gp, a.head_dim), dtype=dtype, device=device)
    wo = torch.zeros((a.n_kv_heads, Gp, a.head_dim, d_model), dtype=dtype, device=device)
    # group-preserving zero padding (pad_q_groups): kv head j serves the
    # first G q slots of its group; padded slots stay zero in wq AND wo
    wq[:, :, :G] = _normal((d_model, a.n_kv_heads, G, a.head_dim), s, dtype, device, generator)
    wo[:, :G] = _normal((a.n_kv_heads, G, a.head_dim, d_model), so, dtype, device, generator)
    p = {
        "wq": wq.reshape(d_model, H, a.head_dim),
        "wk": _normal((d_model, a.n_kv_heads, a.head_dim), s, dtype, device, generator),
        "wv": _normal((d_model, a.n_kv_heads, a.head_dim), s, dtype, device, generator),
        "wo": wo.reshape(H, a.head_dim, d_model),
    }
    if a.qkv_bias:
        p["bq"] = torch.zeros((H, a.head_dim), dtype=dtype, device=device)
        p["bk"] = torch.zeros((a.n_kv_heads, a.head_dim), dtype=dtype, device=device)
        p["bv"] = torch.zeros((a.n_kv_heads, a.head_dim), dtype=dtype, device=device)
    return p


def _qkv(p, x, a: AttnConfig, positions, rope: bool = True):
    q = contract("bsd,dhk->bshk", x, p["wq"])
    k = contract("bsd,dhk->bshk", x, p["wk"])
    v = contract("bsd,dhk->bshk", x, p["wv"])
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope and a.rope_kind == "rope":
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    elif rope and a.rope_kind == "mrope":
        pos3 = positions if positions.ndim == 3 else text_mrope_positions(positions)
        q = apply_mrope(q, pos3, a.rope_theta, a.mrope_sections)
        k = apply_mrope(k, pos3, a.rope_theta, a.mrope_sections)
    return q, k, v


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 1024,
    q_offset: int = 0,
    expand_kv: bool = False,
) -> torch.Tensor:
    """q (B, Sq, H, d), k/v (B, Skv, Hkv, d) -> (B, Sq, H, d).

    Query-chunked with f32 softmax; masks: causal (query position
    q_offset+i attends to kv j <= i) and optional sliding window.
    ``expand_kv`` repeats the kv heads to the full H before the scores: a
    layout lever for sharding in the reference, the same numbers here.
    """
    B, Sq, H, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / (d**0.5)
    qc = min(q_chunk, Sq)
    kv_j = torch.arange(Skv, device=q.device)
    if expand_kv and G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    kf, vf = k.float(), v.float()
    outs = []
    for start in range(0, Sq, qc):
        qi = q[:, start:start + qc]
        n = qi.shape[1]
        if expand_kv:
            qg = qi.reshape(B, n, H, 1, d)  # degenerate group: plain MHA
        else:
            qg = qi.reshape(B, n, Hkv, G, d)
        s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), kf) * scale
        q_pos = q_offset + start + torch.arange(n, device=q.device)
        m = torch.ones((n, Skv), dtype=torch.bool, device=q.device)
        if causal:
            m &= kv_j[None, :] <= q_pos[:, None]
        if window is not None:
            m &= kv_j[None, :] > q_pos[:, None] - window
        s = torch.where(m[None, None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        # the weights round to v's dtype before the product, as the reference's
        o = torch.einsum("bhgqs,bshd->bqhgd", w.to(v.dtype).float(), vf)
        outs.append(o.to(q.dtype).reshape(B, n, H, d))
    return torch.cat(outs, dim=1)


def attn_apply(
    p: dict,
    x: torch.Tensor,
    a: AttnConfig,
    positions: torch.Tensor,
    *,
    window: Optional[int] = None,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Full-sequence self-attention (causal)."""
    q, k, v = _qkv(p, x, a, positions)
    o = chunked_attention(
        q, k, v, causal=True, window=window, q_chunk=q_chunk, expand_kv=a.expand_kv
    )
    return contract("bshk,hkd->bsd", o, p["wo"])


def attn_prefill(
    p: dict,
    x: torch.Tensor,
    a: AttnConfig,
    positions: torch.Tensor,
    cache_len: int,
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill: returns output and (k, v) zero-padded to cache_len."""
    q, k, v = _qkv(p, x, a, positions)
    o = chunked_attention(q, k, v, causal=True, window=window, expand_kv=a.expand_kv)
    B, S = x.shape[:2]
    if S > cache_len:
        raise ValueError(f"prompt of {S} tokens exceeds the cache length {cache_len}")
    ck = k.new_zeros((B, cache_len) + tuple(k.shape[2:]))
    cv = v.new_zeros((B, cache_len) + tuple(v.shape[2:]))
    ck[:, :S] = k
    cv[:, :S] = v
    return contract("bshk,hkd->bsd", o, p["wo"]), (ck, cv)


def attn_decode(
    p: dict,
    x: torch.Tensor,
    a: AttnConfig,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
    use_kernels: Optional[bool] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step.  x (B, 1, d); cache (B, S_max, Hkv, d); lengths (B,)
    = tokens already in cache.  Returns (out (B,1,d), the same cache).

    The new token is written IN PLACE at index ``lengths`` — one row per
    sequence, where the reference rewrites the whole cache through a
    one-hot ``jnp.where``.  A sequence with ``lengths >= S_max`` writes
    nothing (the reference's one-hot matches no row): its old row at the
    clamped index is written back, so nothing indexes past the cache and
    no host sync decides which rows to skip.  Attention then covers
    ``min(lengths + 1, S_max)`` entries (window-limited if ``window``).
    """
    B = x.shape[0]
    positions = lengths[:, None]  # (B, 1)
    q, k_new, v_new = _qkv(p, x, a, positions)
    S = cache_k.shape[1]
    b_idx = torch.arange(B, device=x.device)
    pos = lengths.clamp(max=S - 1)
    fits = (lengths < S)[:, None, None]
    cache_k[b_idx, pos] = torch.where(fits, k_new[:, 0].to(cache_k.dtype), cache_k[b_idx, pos])
    cache_v[b_idx, pos] = torch.where(fits, v_new[:, 0].to(cache_v.dtype), cache_v[b_idx, pos])
    valid = lengths + 1
    if window is None:
        o = da_ops.decode_attn(q[:, 0].contiguous(), cache_k, cache_v, valid,
                              use_kernels=use_kernels)
    else:
        # windowed decode, plain PyTorch as the reference's is plain XLA:
        # mask entries outside [valid - window, valid)
        j = torch.arange(S, device=x.device)
        keep = (j[None] < valid[:, None]) & (j[None] >= (valid - window)[:, None])
        H, d = q.shape[2], q.shape[3]
        Hkv = cache_k.shape[2]
        G = H // Hkv
        qf = q[:, 0].reshape(B, Hkv, G, d)
        s = torch.einsum("bhgd,bshd->bhgs", qf.float(), cache_k.float()) / (d**0.5)
        s = torch.where(keep[:, None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgs,bshd->bhgd", w.to(cache_v.dtype).float(), cache_v.float())
        o = o.reshape(B, H, d).to(x.dtype)
    out = contract("bhk,hkd->bd", o, p["wo"])[:, None]
    return out, (cache_k, cache_v)
