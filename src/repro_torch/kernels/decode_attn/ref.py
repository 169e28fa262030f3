"""Plain PyTorch version of single-token GQA decode attention."""

from __future__ import annotations

import math

import torch


def decode_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """q (B, H, d); k/v (B, S, Hkv, d); lengths (B,) valid KV entries.

    Heads are grouped contiguously: q is read as (B, Hkv, G, d), so query
    head h attends to kv head h // G.  Scores and the PV product are taken
    in f32; entries ``j >= lengths[b]`` are masked, so a length above S
    attends over all S entries.  Returns (B, H, d) in q's dtype.
    """
    B, H, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(d)
    mask = torch.arange(S, device=k.device)[None, :] < lengths[:, None]  # (B, S)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    # the weights round to v's dtype before the product, as the reference's
    o = torch.einsum("bhgs,bshd->bhgd", w.to(v.dtype).float(), v.float())
    return o.reshape(B, H, d).to(q.dtype)
