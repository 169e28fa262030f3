"""Feed-forward blocks: SwiGLU (3 mats) and GELU (2 mats)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dot import mm
from .embedding import _normal


def mlp_init(generator, d: int, d_ff: int, act: str, dtype, device) -> dict:
    s_in = (2.0 / d) ** 0.5
    s_out = (2.0 / d_ff) ** 0.5
    p = {
        "w_in": _normal((d, d_ff), s_in, dtype, device, generator),
        "w_out": _normal((d_ff, d), s_out, dtype, device, generator),
    }
    if act == "swiglu":
        p["w_gate"] = _normal((d, d_ff), s_in, dtype, device, generator)
    else:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_in"])
        return mm(h, p["w_out"])
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(mm(x, p["w_in"]) + p["b_in"], approximate="tanh")
    return mm(h, p["w_out"]) + p["b_out"]
