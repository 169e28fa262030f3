"""Normalization layers (RMSNorm / LayerNorm), f32 statistics.

RMSNorm scales by ``(1 + scale)`` (the scale is initialised to zeros),
with eps 1e-6; LayerNorm uses eps 1e-5.
"""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_apply(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_init(kind: str, d: int, dtype: torch.dtype, device: torch.device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {
        "scale": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }
