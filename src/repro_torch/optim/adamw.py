"""AdamW with selectable state dtype (f32 / bf16 / int8-quantized moments).

The port of ``repro.optim.adamw``: the same update, in float32, on the
port's trees (``optim.tree``).  int8 moments use per-tensor-block absmax
scaling (block = last dim), the standard 8-bit-Adam construction.
Updates are functional, as in the reference: ``apply_updates`` returns
new parameters and a new state and leaves its arguments as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels.dispatch import DeviceLike, resolve_device
from . import tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # float32 | bfloat16 | int8


class QTensor(NamedTuple):
    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # f32 absmax per last-dim block


def _is_q(t) -> bool:
    return isinstance(t, QTensor)


def _quantize(x: torch.Tensor) -> QTensor:
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale.to(torch.float32))


def _dequantize(t: QTensor) -> torch.Tensor:
    return t.q.to(torch.float32) * t.scale


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_state_dtype(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quantize(x)
    return x.to(_DTYPES[dtype])


def _from_state_dtype(x, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize(x)
    return x.to(torch.float32)


def init_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like ``params``, on each parameter's device."""

    def zeros_like_state(p):
        return _to_state_dtype(torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                               cfg.state_dtype)

    dev = tree.leaves(params)[0].device
    return {
        "m": tree.tree_map(zeros_like_state, params),
        "v": tree.tree_map(zeros_like_state, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(t: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed in leaf
    order as the reference does."""
    total = 0
    for leaf in tree.leaves(t):
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(
    params: Any, grads: Any, state: dict, cfg: AdamWConfig
) -> Tuple[Any, dict]:
    """One AdamW step with global-norm clipping; returns (params, state)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        mf = _from_state_dtype(m, cfg.state_dtype)
        vf = _from_state_dtype(v, cfg.state_dtype)
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        mhat = mf / b1c
        vhat = vf / b2c
        u = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        newp = (p.to(torch.float32) - cfg.lr * u).to(p.dtype)
        return (newp, _to_state_dtype(mf, cfg.state_dtype),
                _to_state_dtype(vf, cfg.state_dtype))

    flat_p = tree.leaves(params)
    flat_g = tree.leaves(grads)
    flat_m = tree.leaves(state["m"], is_leaf=_is_q)
    flat_v = tree.leaves(state["v"], is_leaf=_is_q)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and state disagree in their leaves")
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree.unflatten(params, [o[0] for o in out])
    new_m = tree.unflatten(params, [o[1] for o in out])
    new_v = tree.unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; bfloat16 (ml_dtypes) goes
    through its bits, which torch cannot read from numpy directly."""
    a = np.array(a, order="C", copy=True)  # keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def adamw_state_from_numpy(state, device: DeviceLike = None) -> dict:
    """The reference's AdamW state as numpy (``jax.tree.map(np.asarray,
    state)``: moments as float32/bfloat16 arrays or ``QTensor(q, scale)``
    pairs, ``None`` at pools) -> the port's state on ``device`` (``None``:
    the card)."""
    dev = resolve_device(device)

    def conv(t):
        if hasattr(t, "q") and hasattr(t, "scale"):
            return QTensor(tensor_from_numpy(t.q, dev), tensor_from_numpy(t.scale, dev))
        return tensor_from_numpy(t, dev)

    def moments(tr):
        return tree.tree_map(conv, tr, is_leaf=lambda t: hasattr(t, "q") and hasattr(t, "scale"))

    return {"m": moments(state["m"]), "v": moments(state["v"]),
            "step": tensor_from_numpy(state["step"], dev).to(torch.int32)}
