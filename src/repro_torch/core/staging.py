"""Host → device staging on a side CUDA stream: the port's PCIe copies.

``HostStager`` copies host tensors into fresh device tensors on a side
stream, so a copy overlaps the kernels already queued on the compute
stream.  The copy is asynchronous when the host tensor is pinned
(``pin``); the executor's host-resident volumes and the sub-layers' host
operands are.  Each staged tensor comes back with a ready event: the
compute stream waits on it (``wait``) before its first read, and the
tensor is marked with ``record_stream`` for the compute stream, so the
caching allocator does not hand its block out again while work that
reads it is still queued.  On a CPU device the copy is a plain one and
there is nothing to wait for.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pin(host, device: torch.device) -> torch.Tensor:
    """A host tensor holding ``host`` (an ndarray or CPU tensor), in pinned
    memory when ``device`` is a CUDA device (so copies to it can run
    asynchronously); a failed pinned allocation raises."""
    src = torch.as_tensor(np.asarray(host)) if isinstance(host, np.ndarray) else host
    if torch.device(device).type != "cuda":
        return src
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    out.copy_(src)
    return out


class HostStager:
    """Stages host tensors onto one device, each copy on a side stream."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    def stage(
        self, src: torch.Tensor, rows: Optional[int] = None
    ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Start copying ``src`` into a new device tensor; ``rows`` (≥ the
        rows of ``src``) zero-fills dim 0 past them.  Returns the tensor
        and its ready event (None when nothing is in flight).  A tensor
        already on the device, unpadded, is returned as it is."""
        n = int(src.shape[0])
        rows = n if rows is None else int(rows)
        if src.device == self.device and rows == n:
            return src, None
        shape = (rows,) + tuple(src.shape[1:])
        alloc = torch.empty if rows == n else torch.zeros
        if self.stream is None:
            dst = alloc(shape, dtype=src.dtype, device=self.device)
            dst[:n].copy_(src)
            return dst, None
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            # allocated on the side stream: its block was last used there,
            # so the copy cannot overwrite memory queued compute work reads
            dst = alloc(shape, dtype=src.dtype, device=self.device)
            dst[:n].copy_(src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        dst.record_stream(compute)
        return dst, ready

    def wait(self, ready: Optional[torch.cuda.Event]) -> None:
        """Make the compute stream wait for one staged copy."""
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
