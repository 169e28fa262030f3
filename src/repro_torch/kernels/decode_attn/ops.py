"""Wrapper for flash-decode: dispatch the CUDA kernel vs its plain version.

Unlike the reference's wrapper, this one never pads S to a block multiple:
the reference's ``jnp.pad`` copies every layer's cache at every decode
step, and the kernel masks the ragged end of the cache itself.  It reads
q as (B, Hkv, G, d) — heads grouped contiguously, query head h served by
kv head h // G — which is q's own (B, H, d) memory, so nothing is copied.

A length above S attends over all S entries, as the reference's ``ref.py``
does (its Pallas path would count the zero padding as valid there).
``lengths == 0`` is not part of the contract: ``attn_decode`` always
passes ``lengths + 1``.

The kernel splits S into chunks of ``CHUNK`` rows, one block each, and a
second kernel combines the chunks' f32 partials; the wrapper allocates
their workspace through PyTorch's caching allocator (``ref.decode_attn_split``
replays the split on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..dispatch import check_no_grad, check_operand, resolve_use_kernels
from . import ref as _ref

launches = {"decode_attn": 0}

MAX_G = 16
MAX_D = 256
# cache rows a block of the split kernel takes (four 64-row tiles): up to
# 8 chunks a sequence at the served S = 2048, about one wave of blocks on
# the card at the served lengths
CHUNK = 256
_ENTRY = {torch.float32: "decode_attn_f32", torch.bfloat16: "decode_attn_bf16"}


def decode_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """q (B, H, d); k/v (B, S, Hkv, d); lengths (B,) -> (B, H, d) in q's dtype."""
    B, H, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, S, Hkv, d) = {(B, S, Hkv, d)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if not resolve_use_kernels(use_kernels, q):
        return _ref.decode_attn(q, k, v, lengths)
    check_no_grad("decode_attn", q, k, v)
    G = H // Hkv
    if q.dtype not in _ENTRY:
        raise TypeError(f"decode_attn kernel takes float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_operand(t, name, q.dtype)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if G > MAX_G or d > MAX_D or d % 8:
        raise ValueError(f"decode_attn kernel needs G <= {MAX_G} and d <= {MAX_D} "
                         f"with d % 8 == 0, got G={G}, d={d}")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    # per (sequence, kv head, chunk): m[G], l[G], acc[G][d]
    part = torch.empty(B * Hkv * -(-S // CHUNK) * G * (d + 2), dtype=torch.float32,
                       device=q.device)
    err = getattr(build.library(), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, S, Hkv, G, d, CHUNK, build.stream_of(q),
    )
    build.check(err, "decode_attn")
    launches["decode_attn"] += 1
    return out
