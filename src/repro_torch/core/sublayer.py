"""Sub-layer decomposition — ZNNi's "GPU + host RAM" layer (§VII-A, Fig. 6).

The paper splits one convolutional layer's (S, f, f') work grid into
sub-layers sized to fit the GPU's on-board RAM, streaming inputs and
outputs over PCIe.  On one card the port does the same: the backing store
is host RAM (the reference's is the mesh's aggregate HBM, its slow link
ICI), and the slow link is the card's host link.

* ``streamed_conv_out_channels`` — Fig. 6's f'-split: the conv runs over
  output-channel chunks of the weights; live spectra scale with the
  chunk, not with f'.
* ``streamed_conv_batch`` — the S-split the paper prefers when S > 1
  ("each input transferred exactly once").

Both run on ``device`` (default: where ``x`` lies).  An operand that lies
elsewhere — host RAM, pinned for an asynchronous copy — is staged chunk
by chunk, each chunk copied one ahead on a side stream
(``staging.HostStager``) while the current chunk computes, and each
output chunk comes back to where ``x`` lies.  With every operand on the
device they are the reference's chunked maps.  Padding, chunk order and
result are the reference's (``src/repro/core/sublayer.py``).

* ``gathered_conv`` — the weights arrive sharded along f' over the ranks
  of a ``torch.distributed`` process group: each rank convolves its
  output-channel slice, then the slices are all-gathered along channels
  through host memory (``distributed.host_group``), so every rank holds
  the whole output: the paper's "results transferred back to host
  exactly once".
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributed.host_group import all_gather_cat
from ..kernels.dispatch import DeviceLike
from .primitives import conv_apply
from .staging import HostStager


def _out_buffer(shape, like: torch.Tensor, home: torch.device, dev: torch.device):
    """The output chunks' home: pinned host memory when the chunks come
    back from a card (so each copy back is asynchronous)."""
    pinned = home.type == "cpu" and dev.type == "cuda"
    return torch.empty(shape, dtype=like.dtype, device=home, pin_memory=pinned)


def _finish(dev: torch.device) -> None:
    # the output chunks' copies back are queued on the compute stream
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def streamed_conv_out_channels(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    chunk: int,
    variant: str = "fft",
    use_kernels: Optional[bool] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Split f' into chunks (paper Fig. 6 with S_i=S, f_i=f, f'_i=chunk).

    f' is zero-padded to a multiple of ``chunk`` (the last chunk's padded
    channels are computed and dropped, as in the reference); ``x`` is
    staged once, the weight chunks one ahead of the chunk that runs.
    """
    dev = x.device if device is None else torch.device(device)
    home = x.device
    fp = int(w.shape[0])
    n_chunks = -(-fp // chunk)
    if b is None:
        b = torch.zeros(fp, dtype=w.dtype, device=w.device)
    stager = HostStager(dev)
    x_d, x_ready = stager.stage(x)

    def stage(i):
        lo, hi = i * chunk, min((i + 1) * chunk, fp)
        wi, w_ready = stager.stage(w[lo:hi], rows=chunk)
        bi, b_ready = stager.stage(b[lo:hi], rows=chunk)
        return wi, bi, (w_ready, b_ready)

    out = None
    nxt = stage(0)
    stager.wait(x_ready)
    for i in range(n_chunks):
        wi, bi, ready = nxt
        if i + 1 < n_chunks:
            nxt = stage(i + 1)
        for ev in ready:
            stager.wait(ev)
        o = conv_apply(variant, x_d, wi, bi, use_kernels=use_kernels)
        if out is None:
            out = _out_buffer((o.shape[0], fp) + tuple(o.shape[2:]), o, home, dev)
        lo, hi = i * chunk, min((i + 1) * chunk, fp)
        # the chunk's real channels of each sample: a contiguous run of
        # the output, so every copy back is one asynchronous transfer
        for s_ in range(o.shape[0]):
            out[s_, lo:hi].copy_(o[s_, : hi - lo], non_blocking=True)
    _finish(dev)
    return out


def streamed_conv_batch(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    chunk: int,
    variant: str = "fft",
    use_kernels: Optional[bool] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Split S into sub-batches (paper's preferred split when S > 1): the
    weights are staged once, the input sub-batches one ahead."""
    S = int(x.shape[0])
    if S % chunk:
        raise ValueError(f"batch {S} not divisible by sub-batch {chunk}")
    dev = x.device if device is None else torch.device(device)
    stager = HostStager(dev)
    w_d, w_ready = stager.stage(w)
    b_d, b_ready = (None, None) if b is None else stager.stage(b)
    n_chunks = S // chunk
    out = None
    nxt = stager.stage(x[:chunk])
    stager.wait(w_ready)
    stager.wait(b_ready)
    for i in range(n_chunks):
        xi, ready = nxt
        if i + 1 < n_chunks:
            nxt = stager.stage(x[(i + 1) * chunk : (i + 2) * chunk])
        stager.wait(ready)
        o = conv_apply(variant, xi, w_d, b_d, use_kernels=use_kernels)
        if out is None:
            out = _out_buffer((S,) + tuple(o.shape[1:]), o, x.device, dev)
        out[i * chunk : (i + 1) * chunk].copy_(o, non_blocking=True)
    _finish(dev)
    return out


def gathered_conv(
    x: torch.Tensor,
    w_shard: torch.Tensor,
    b_shard: Optional[torch.Tensor],
    *,
    group=None,
    variant: str = "fft",
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Every rank of ``group`` calls it with the whole input ``x`` and its
    slice of the weights along f' (w_shard (f'/n, f, k³), slices in rank
    order): a local conv of that slice (no gather needed for the
    compute), then the slices all-gathered along channels, so every rank
    returns the full (S, f', n'³) output.  Bytes through host memory: the
    output tensor once around the group (the analogue of Fig. 6's green
    arrows).
    """
    o_local = conv_apply(variant, x, w_shard, b_shard, use_kernels=use_kernels)
    return all_gather_cat(o_local, 1, group)
