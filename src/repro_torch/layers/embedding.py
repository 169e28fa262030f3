"""Token embeddings, the logits head, the token cross-entropy and the
sinusoidal position table."""

from __future__ import annotations

import torch

from .dot import mm


def _normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    """N(0, std²) drawn in f32 on the generator's device, cast to dtype
    (scaled in place: one f32 copy at a time)."""
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.mul_(std).to(device=device, dtype=dtype)


def embed_init(generator, vocab: int, d: int, tie: bool, dtype, device) -> dict:
    p = {"tok": _normal((vocab, d), 0.02, dtype, device, generator)}
    if not tie:
        p["head"] = _normal((d, vocab), 0.02, dtype, device, generator)
    return p


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def head_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    w = p.get("head")
    if w is None:
        w = p["tok"].T
    return mm(x, w)


_CE_CHUNK = 512


def _ce_chunks(S: int):
    """The reference's chunks of ``min(512, S)`` positions.  It zero-pads S
    to a multiple of the chunk and drops the padded positions' values; the
    port's last chunk is the remainder, which computes the same numbers
    without copying the logits."""
    c = min(_CE_CHUNK, S)
    return [(s0, min(s0 + c, S)) for s0 in range(0, S, c)]


class _CrossEntropy(torch.autograd.Function):
    """Mean token CE in f32, the reference's ``custom_vjp``.

    The forward keeps only the per-token ``lse - gold`` (B, S) f32, never
    a full (B, S, V) f32 copy: one (B, chunk, V) f32 chunk at a time.  The
    backward recomputes the softmax chunk by chunk and writes
    ``(softmax - onehot) * g / (B*S)`` into a gradient in the logits'
    dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        B, S, _ = logits.shape
        y = labels.long()
        per_tok = logits.new_empty((B, S), dtype=torch.float32)
        for s0, s1 in _ce_chunks(S):
            lf = logits[:, s0:s1].float()
            gold = lf.gather(-1, y[:, s0:s1, None])[..., 0]
            per_tok[:, s0:s1] = torch.logsumexp(lf, dim=-1) - gold
            del lf
        ctx.save_for_backward(logits, labels)
        return per_tok.mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        B, S, V = logits.shape
        y = labels.long()
        scale = g / (B * S)
        d = torch.empty(logits.shape, dtype=logits.dtype, device=logits.device)
        for s0, s1 in _ce_chunks(S):
            p = torch.softmax(logits[:, s0:s1].float(), dim=-1)
            p.scatter_add_(-1, y[:, s0:s1, None],
                           torch.full((B, s1 - s0, 1), -1.0, device=p.device))
            d[:, s0:s1] = p.mul_(scale)
            del p
        return d, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in f32.  logits (B, S, V) any float dtype, labels (B, S)
    int.  Its gradient is recomputed chunk by chunk in the backward
    (``_CrossEntropy``)."""
    return _CrossEntropy.apply(logits, labels)


def sinusoidal_positions(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) f32 fixed sinusoidal table (whisper-style positions)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    out = torch.zeros((S, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out
