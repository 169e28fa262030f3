"""Mamba2 block via SSD (state-space duality) chunked form [arXiv:2405.21060].

As the reference: the sequence splits into chunks of Q; within a chunk
the quadratic "attention-like" form runs (decay matrix
L = exp(segsum(a))), and a scan carries the (H, P, N) state across
chunks.  Block: projections -> causal conv1d (width d_conv over x/B/C,
cached for decode) -> SSD -> gated RMSNorm (silu(z)) -> out_proj.

Port notes:
  * the chunk scan is a Python loop over chunks (``lax.scan`` there); the
    reference's unroll switch exists for its dry run's probes only;
  * ``ssd_chunked``'s multi-operand einsums are split into pairwise
    products in a fixed order, so no (b, h, c, q, q, p)-sized
    intermediate is ever formed;
  * ``ssm_decode`` writes the new conv window and state into the caller's
    cache IN PLACE and returns the same tensors, as ``attn_decode`` does
    with K/V; the reference returns new arrays.

Decode carries (conv_cache (B, d_conv-1, ch), ssm_state (B, H, P, N)) —
O(1) in sequence length.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from .dot import mm
from .embedding import _normal
from .norms import rmsnorm


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., q) -> (..., q, q): L[i,j] = sum_{j < t <= i} a_t (lower-tri, else -inf)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssm_init(generator, d_model: int, s: SSMConfig, dtype, device) -> dict:
    di = s.d_inner(d_model)
    nh = s.n_ssm_heads(d_model)
    scale = (2.0 / d_model) ** 0.5

    def unit_last(ch):
        w = torch.zeros((s.d_conv, ch), dtype=dtype, device=device)
        w[-1] = 1.0
        return w

    return {
        "w_z": _normal((d_model, di), scale, dtype, device, generator),
        "w_x": _normal((d_model, di), scale, dtype, device, generator),
        "w_B": _normal((d_model, s.d_state), scale, dtype, device, generator),
        "w_C": _normal((d_model, s.d_state), scale, dtype, device, generator),
        "w_dt": _normal((d_model, nh), scale, dtype, device, generator),
        "conv_x": _normal((s.d_conv, di), 0.3, dtype, device, generator),
        "conv_B": unit_last(s.d_state),
        "conv_C": unit_last(s.d_state),
        "conv_bx": torch.zeros((di,), dtype=dtype, device=device),
        "conv_bB": torch.zeros((s.d_state,), dtype=dtype, device=device),
        "conv_bC": torch.zeros((s.d_state,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=device),
        "w_out": _normal((di, d_model), (2.0 / di) ** 0.5, dtype, device, generator),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time + silu. x (B, L, ch), w (d_conv, ch)."""
    dk = w.shape[0]
    pad = F.pad(x, (0, 0, dk - 1, 0))
    out = torch.zeros_like(x)
    for t in range(dk):
        out = out + pad[:, t : t + x.shape[1]] * w[t]
    return F.silu(out + b)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A_log: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD core.  x (b,l,h,p); dt (b,l,h) >0; A_log (h,); B/C (b,l,n); D (h,).

    Returns (y (b,l,h,p) f32, final_state (b,h,p,n) f32).  l must be
    divisible by ``chunk`` (callers pad).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    a = (-torch.exp(A_log)[None, None] * dt).float()  # (b,l,h)
    xdt = (x * dt[..., None]).float()

    xc = xdt.reshape(b, nc, chunk, h, p)
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)  # (b,h,c,q)
    Bc = B.float().reshape(b, nc, chunk, n)
    Cc = C.float().reshape(b, nc, chunk, n)

    # diagonal blocks: y[q] = sum_k (C_q . B_k) L[q,k] x_k
    L = torch.exp(_segsum(ac))  # (b,h,c,q,k)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", L * CB[:, None], xc)

    # each chunk's state from its own inputs
    a_cum = torch.cumsum(ac, dim=-1)  # (b,h,c,q)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (b,h,c,q)
    states = torch.einsum("bckn,bckhp->bchpn", Bc,
                          xc * decay_states.permute(0, 2, 3, 1)[..., None])

    # the scan across chunks: the state at each chunk's START
    chunk_decay = torch.exp(a_cum[..., -1])  # (b,h,c)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,c,h,p,n)

    state_decay = torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]  # (b,c,q,h,1)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) * state_decay

    y = (y_diag + y_off).reshape(b, l, h, p) + x.float() * D[None, None, :, None]
    return y, s


def _project(p, x):
    return (mm(x, p["w_z"]), mm(x, p["w_x"]), mm(x, p["w_B"]), mm(x, p["w_C"]),
            mm(x, p["w_dt"]))


def _conv_all(p, xs, Bv, Cv):
    xs = _causal_conv(xs, p["conv_x"], p["conv_bx"])
    Bv = _causal_conv(Bv, p["conv_B"], p["conv_bB"])
    Cv = _causal_conv(Cv, p["conv_C"], p["conv_bC"])
    return xs, Bv, Cv


def _run_ssd(p, xs, Bv, Cv, dt, z, s: SSMConfig, L: int, nh: int, di: int):
    dtf = F.softplus(dt.float() + p["dt_bias"])
    pad = (-L) % s.chunk
    if pad:
        xs, Bv, Cv, dtf = (F.pad(t, (0, 0, 0, pad)) for t in (xs, Bv, Cv, dtf))
    B_ = xs.shape[0]
    y, state = ssd_chunked(
        xs.reshape(B_, L + pad, nh, s.headdim), dtf, p["A_log"], Bv, Cv, p["D"], s.chunk,
    )
    y = y[:, :L].reshape(B_, L, di).to(z.dtype)
    return rmsnorm(y * F.silu(z), p["norm_scale"]), state


def ssm_apply(p: dict, x: torch.Tensor, s: SSMConfig, d_model: int) -> torch.Tensor:
    """Full-sequence Mamba2 block. x (B, L, d_model) -> (B, L, d_model)."""
    di, nh = s.d_inner(d_model), s.n_ssm_heads(d_model)
    z, xs, Bv, Cv, dt = _project(p, x)
    xs, Bv, Cv = _conv_all(p, xs, Bv, Cv)
    y, _ = _run_ssd(p, xs, Bv, Cv, dt, z, s, x.shape[1], nh, di)
    return mm(y, p["w_out"])


def ssm_prefill(
    p: dict, x: torch.Tensor, s: SSMConfig, d_model: int
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Like ``ssm_apply`` but also returns (conv_cache, ssm_state) for
    decode.  conv_cache holds the last d_conv-1 *pre-conv* channel values
    of concat(x, B, C)."""
    di, nh = s.d_inner(d_model), s.n_ssm_heads(d_model)
    z, xs, Bv, Cv, dt = _project(p, x)
    conv_cache = torch.cat([xs, Bv, Cv], dim=-1)[:, -(s.d_conv - 1):, :]
    xs, Bv, Cv = _conv_all(p, xs, Bv, Cv)
    y, state = _run_ssd(p, xs, Bv, Cv, dt, z, s, x.shape[1], nh, di)
    return mm(y, p["w_out"]), (conv_cache.to(x.dtype), state.float())


def ssm_decode(
    p: dict,
    x: torch.Tensor,
    s: SSMConfig,
    d_model: int,
    conv_cache: torch.Tensor,
    state: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step.  x (B, 1, d_model); conv_cache (B, d_conv-1, ch);
    state (B, h, p, n) f32.  Returns (y (B,1,d_model), (conv_cache,
    state)): the caller's cache tensors, updated in place."""
    di, nh = s.d_inner(d_model), s.n_ssm_heads(d_model)
    B_ = x.shape[0]
    z, xs, Bv, Cv, dt = _project(p, x[:, 0])  # (B, ·)
    xBC = torch.cat([xs, Bv, Cv], dim=-1)  # (B, ch)
    window = torch.cat([conv_cache.to(xBC.dtype), xBC[:, None]], dim=1)
    w_all = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    b_all = torch.cat([p["conv_bx"], p["conv_bB"], p["conv_bC"]], dim=-1)
    conv = F.silu(torch.einsum("btc,tc->bc", window, w_all) + b_all)
    conv_cache.copy_(window[:, 1:])
    xs, Bv, Cv = torch.split(conv, [di, s.d_state, s.d_state], dim=-1)
    dtf = F.softplus(dt.float() + p["dt_bias"])  # (B, nh)
    xh = xs.reshape(B_, nh, s.headdim).float()
    dA = torch.exp(-torch.exp(p["A_log"])[None] * dtf)  # (B, nh)
    dBx = torch.einsum("bn,bhp->bhpn", Bv.float(), xh * dtf[..., None])
    state.copy_(state * dA[..., None, None] + dBx)
    y = torch.einsum("bn,bhpn->bhp", Cv.float(), state)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B_, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    return mm(y, p["w_out"])[:, None], (conv_cache, state)
