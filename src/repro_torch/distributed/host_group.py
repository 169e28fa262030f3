"""Process groups over ``torch.distributed``, exchanged through host memory.

The port's counterpart of a mesh axis is a process group passed as
``group=`` (``None``: the default group).  Nothing tells a program of a
cluster, so ``init_host_group`` is given its address, world size and rank,
and a timeout.  Without an initialized default group a program is one
process: ``group_size`` is 1 and the callers run their one-process paths.

The backend is gloo, whose point-to-point and gather take host tensors
only (and two ranks that share one card cannot use NCCL).  So every
hand-off goes through host memory in the open: a device tensor is copied
into a pinned host buffer, exchanged, and copied back to its device.
``exchanged_bytes`` counts what this process sent and received, the bytes
handed to gloo and taken from it.
"""

from __future__ import annotations

import datetime
import socket
from typing import Dict, Optional

import torch
import torch.distributed as dist

_BYTES: Dict[str, int] = {"sent": 0, "received": 0}


def init_host_group(
    rank: int, world_size: int, port: int, *, timeout_s: float = 60.0,
    addr: str = "127.0.0.1",
) -> None:
    """Join the default gloo group at ``tcp://addr:port`` as ``rank``."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}:{port}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s),
    )


def free_port(addr: str = "127.0.0.1") -> int:
    """A TCP port on ``addr`` that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((addr, 0))
        return int(s.getsockname()[1])


def group_size(group=None) -> int:
    """Ranks in ``group`` (``None``: the default group); 1 when no default
    group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def exchanged_bytes() -> Dict[str, int]:
    """Bytes this process sent and received through host memory."""
    return dict(_BYTES)


def reset_exchanged_bytes() -> None:
    _BYTES["sent"] = _BYTES["received"] = 0


def _global(group, r: int) -> int:
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def _host_buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty host tensor shaped like ``like``; pinned when ``like`` lies
    on a card, so the copies to and from it are DMA transfers."""
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=like.is_cuda)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return t.contiguous()
    h = _host_buffer(t)
    h.copy_(t)
    return h


def exchange(
    send: Optional[torch.Tensor],
    dst: Optional[int],
    recv_like: Optional[torch.Tensor],
    src: Optional[int],
    group=None,
) -> Optional[torch.Tensor]:
    """Send ``send`` to group rank ``dst`` while receiving a tensor shaped
    like ``recv_like`` from group rank ``src``; either side may be
    ``None``.  Returns the received tensor on ``recv_like``'s device."""
    reqs = []
    if send is not None:
        h_send = _to_host(send)
        reqs.append(dist.isend(h_send, _global(group, dst), group=group))
        _BYTES["sent"] += _nbytes(h_send)
    h_recv = None
    if recv_like is not None:
        h_recv = _host_buffer(recv_like)
        reqs.append(dist.irecv(h_recv, _global(group, src), group=group))
    for req in reqs:
        req.wait()
    if h_recv is None:
        return None
    _BYTES["received"] += _nbytes(h_recv)
    return h_recv.to(recv_like.device)


def all_gather_cat(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each), concatenated along ``dim``
    in rank order, on ``t``'s device."""
    n = group_size(group)
    h = _to_host(t)
    parts = [_host_buffer(t) for _ in range(n)]
    dist.all_gather(parts, h, group=group)
    _BYTES["sent"] += _nbytes(h)
    _BYTES["received"] += (n - 1) * _nbytes(h)
    return torch.cat([p.to(t.device) for p in parts], dim=dim)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` (same shape on each), on ``t``'s
    device; gloo adds in its own order, the same result on every rank."""
    h = _to_host(t).clone()
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
    _BYTES["sent"] += _nbytes(h)
    _BYTES["received"] += _nbytes(h)
    return h.to(t.device)
