"""Modality frontend stubs: the transformer backbone is real; the vision and
audio frontends supply *precomputed* embeddings.

* ``vlm``  (qwen2-vl): the first ``n_patches`` sequence positions carry
  patch embeddings (B, n_patches, d_model); the rest are text tokens.
  M-RoPE ids for the patch block use a synthetic (t, h, w) grid; text
  continues 1D.
* ``audio`` (whisper): the encoder consumes frame embeddings
  (B, enc_seq, d_model) directly (``models/encdec.py``).

Decode does not continue these ids: ``attn_decode`` gives the next token
the 1D position ``lengths``, where a prefill of S > n_patches tokens gave
its last text token ``max(t, h, w) + S - 1 - n_patches``.  The reference
does the same (its decode parts from its forward after a 256-patch
prefill), and the port keeps its numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch

# patch grid assumed by the stub (t=4, h=8, w=8 -> 256 patch positions)
VLM_PATCH_GRID: Tuple[int, int, int] = (4, 8, 8)
VLM_N_PATCHES = VLM_PATCH_GRID[0] * VLM_PATCH_GRID[1] * VLM_PATCH_GRID[2]


def vlm_splice(tok_embeds: torch.Tensor, patch_embeds: torch.Tensor) -> torch.Tensor:
    """Replace the first n_patches positions with the patch embeddings."""
    n = patch_embeds.shape[1]
    return torch.cat([patch_embeds.to(tok_embeds.dtype), tok_embeds[:, n:]], dim=1)


def vlm_mrope_positions(B: int, S: int, n_patches: int = VLM_N_PATCHES,
                        device=None) -> torch.Tensor:
    """(3, B, S) int64 M-RoPE ids: the (t, h, w) grid over the patch block
    (truncated to n_patches), then text positions continuing from
    max(t, h, w) of the grid (the qwen2-vl scheme)."""
    t, h, w = VLM_PATCH_GRID

    def ar(n):
        return torch.arange(n, device=device)

    ids_t = ar(t).repeat_interleave(h * w)[:n_patches]
    ids_h = ar(h).repeat_interleave(w).repeat(t)[:n_patches]
    ids_w = ar(w).repeat(t * h)[:n_patches]
    grid = torch.stack([ids_t, ids_h, ids_w])  # (3, n_patches)
    text = ar(S - n_patches) + max(t, h, w)  # (S - n_patches,)
    pos = torch.cat([grid, text[None].expand(3, S - n_patches)], dim=1)  # (3, S)
    return pos[:, None, :].expand(3, B, S)
