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


def decode_attn_split(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    chunk: int,
) -> torch.Tensor:
    """The CUDA kernel's pass structure in plain PyTorch, for the tests.

    S splits into chunks of ``chunk`` rows; each chunk that holds a valid
    row gives an f32 partial — its max score ``m``, the sum ``l`` of
    ``exp(score - m)`` and the unnormalised ``acc = sum exp(score - m) v`` —
    and the combine folds the partials in chunk order, rescaling its
    running sums whenever the running max rises, then divides by the
    rescaled sum of ``l``.  As in the kernel, the weights stay
    unnormalised, rounded to v's dtype for PV (bf16 on the tensor cores,
    f32 as they are).  Returns (B, H, d) in q's dtype.
    """
    B, H, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qs = q.reshape(B, Hkv, G, d).float() * (1.0 / math.sqrt(d))
    out = torch.empty((B, Hkv, G, d), dtype=torch.float32)
    for b in range(B):
        L = min(int(lengths[b]), S)
        parts = []
        for r0 in range(0, L, chunk):
            kc = k[b, r0:min(r0 + chunk, L)].float()  # (n, Hkv, d)
            vc = v[b, r0:min(r0 + chunk, L)].float()
            s = torch.einsum("hgd,nhd->hgn", qs[b], kc)
            m = s.amax(dim=-1)
            e = torch.exp(s - m[..., None])
            pv = torch.einsum("hgn,nhd->hgd", e.to(v.dtype).float(), vc)
            parts.append((m, e.sum(dim=-1), pv))
        m_run = torch.full((Hkv, G), float("-inf"))
        l = torch.zeros((Hkv, G))
        acc = torch.zeros((Hkv, G, d))
        for m, lc, ac in parts:
            m_new = torch.maximum(m_run, m)
            r, e = torch.exp(m_run - m_new), torch.exp(m - m_new)
            l = l * r + lc * e
            acc = acc * r[..., None] + ac * e[..., None]
            m_run = m_new
        out[b] = acc / l[..., None]
    return out.reshape(B, H, d).to(q.dtype)
