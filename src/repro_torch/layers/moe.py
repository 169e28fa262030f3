"""Top-k MoE with capacity-bounded sort-free dispatch (GShard-style).

As the reference: per-expert positions come from a (T·K, E) cumsum,
tokens scatter into an (E·C, d) buffer (unique destinations; tokens past
an expert's capacity go to one overflow scratch row, the only duplicate
destination), the expert FFNs run as one batched einsum over the stacked
expert weights, and the results gather back weighted by the router.
Tokens beyond capacity are dropped; the router adds the load-balancing
aux loss of Shazeer et al.

``routing_groups`` computes capacity and dispatch per token group (the
reference's sharding lever; on one device it changes only which tokens
share a capacity).

Top-k takes a stable descending sort, so equal router probabilities
rank the lower expert index first, as ``lax.top_k`` does.  The expert
products are plain ``einsum`` calls in ``layers/dot.py``'s accumulation:
the reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from .dot import contract
from .embedding import _normal


def moe_init(generator, d: int, d_ff: int, cfg: MoEConfig, act: str, dtype, device) -> dict:
    E = cfg.n_experts
    s_in = (2.0 / d) ** 0.5
    s_out = (2.0 / d_ff) ** 0.5
    p = {
        "router": _normal((d, E), s_in, torch.float32, device, generator),
        "w_in": _normal((E, d, d_ff), s_in, dtype, device, generator),
        "w_out": _normal((E, d_ff, d), s_out, dtype, device, generator),
    }
    if act == "swiglu":
        p["w_gate"] = _normal((E, d, d_ff), s_in, dtype, device, generator)
    return p


def route(p: dict, xt: torch.Tensor, cfg: MoEConfig):
    """xt (G, Tg, d) -> (probs (G, Tg, E) f32, renormalised top-k weights
    (G, Tg, K), expert ids (G, Tg, K))."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[..., : cfg.top_k], idx[..., : cfg.top_k]
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def moe_apply(
    p: dict,
    x: torch.Tensor,
    cfg: MoEConfig,
    act: str,
    *,
    routing_groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar f32)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    Gr = routing_groups
    if T % Gr:
        raise ValueError(f"{T} tokens do not split into {Gr} routing groups")
    Tg = T // Gr
    xt = x.reshape(Gr, Tg, d)
    probs, topw, topi = route(p, xt, cfg)

    # aux load-balance loss: E * sum_e fraction_tokens(e) * mean_prob(e)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce) * cfg.aux_loss_weight

    C = int(max(1, cfg.capacity_factor * Tg * K / E))
    flat_i = topi.reshape(Gr, Tg * K)  # expert id per (token, k) slot
    oh = F.one_hot(flat_i, E)  # (Gr, TgK, E)
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(dim=2)  # rank within expert
    dest = torch.where(pos < C, flat_i * C + pos, E * C)  # overflow -> scratch row
    idx = dest[..., None].expand(Gr, Tg * K, d)

    xr = xt.repeat_interleave(K, dim=1)  # (Gr, TgK, d): the token of each slot
    buf = x.new_zeros((Gr, E * C + 1, d)).scatter_(1, idx, xr)
    # fold the groups into the capacity dim: one (E, Gr·C, d) product
    ein = buf[:, : E * C].reshape(Gr, E, C, d).transpose(0, 1).reshape(E, Gr * C, d)
    if act == "swiglu":
        h = F.silu(contract("ecd,edf->ecf", ein, p["w_gate"])) * contract(
            "ecd,edf->ecf", ein, p["w_in"]
        )
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(contract("ecd,edf->ecf", ein, p["w_in"]), approximate="tanh")
    eout = contract("ecf,efd->ecd", h, p["w_out"])
    eout = eout.reshape(E, Gr, C, d).transpose(0, 1).reshape(Gr, E * C, d)
    eout = torch.cat([eout, eout.new_zeros((Gr, 1, d))], dim=1)

    slot_out = torch.gather(eout, 1, idx) * topw.reshape(Gr, Tg * K, 1).to(eout.dtype)
    out = slot_out.reshape(Gr, Tg, K, d).sum(dim=2)
    return out.reshape(B, S, d), aux
