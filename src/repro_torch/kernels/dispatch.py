"""The ONE kernel-dispatch rule of the port: ``use_kernels`` is a tri-state.

Every kernel wrapper (and everything above it: ``core/fft_conv``,
``core/overlap_save``, ``core/mpf``, ``compile_plan``, ``PlanExecutor``,
``VolumeEngine``) takes ``use_kernels: Optional[bool]``:

* ``None``  — the hand-written Hopper kernel iff the tensor lies on a
  CUDA device, its plain PyTorch version (``ref.py``) iff it lies on the
  CPU;
* ``True``  — the kernel; a CPU tensor raises;
* ``False`` — the plain version, an explicit caller choice (comparisons
  and timings of the plain versions; the main path never passes it).

There is no fallback: a kernel that fails to build or launch raises, it
never silently runs the plain version instead.

Only ``conv3d`` and ``mpf_pool`` have backward kernels (the primitives
``direct`` and ``mpf``, which training uses, as the reference does).  The
other kernels call ``check_no_grad`` on their kernel path, so a gradient
asked of them raises instead of stopping silently at their output.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for but absent —
    the port never quietly drops to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device present; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def resolve_use_kernels(
    use_kernels: Optional[bool], device: Union[torch.device, torch.Tensor]
) -> bool:
    """Resolve the tri-state against the device the data lives on."""
    if isinstance(device, torch.Tensor):
        device = device.device
    on_cuda = torch.device(device).type == "cuda"
    if use_kernels is None:
        return on_cuda
    if use_kernels and not on_cuda:
        raise ValueError("use_kernels=True needs tensors on a CUDA device")
    return bool(use_kernels)


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Validate a kernel operand before its pointer goes to C."""
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.is_conj():
        raise ValueError(f"{name} carries a lazy conjugate bit; resolve it first")


def check_no_grad(what: str, *operands) -> None:
    """Raise when autograd would record a kernel that has no backward: its
    output would carry no gradient to the operands that need one."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{what} has no backward kernel, and an operand requires grad; "
            "train with the 'direct' and 'mpf' primitives, or run it under "
            "torch.no_grad()"
        )
