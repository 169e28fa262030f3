"""Matmul helpers: f32 accumulation, result in the operand's dtype.

The reference asks XLA for f32 accumulation through
``preferred_element_type`` and casts back.  PyTorch's bf16 products
already return bf16, but on the card cuBLAS may reduce a bf16 GEMM in bf16
unless ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
is False; an f32 GEMM may run in TF32 if ``allow_tf32`` is set.  The LM
entry points (``ServingEngine``, ``launch/serve.py``) run their model
calls inside ``f32_accumulation()``, which clears both for the call.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_accumulation():
    """Matmuls accumulate in full f32 inside the block (restored after)."""
    m = torch.backends.cuda.matmul
    prev = (m.allow_bf16_reduced_precision_reduction, m.allow_tf32)
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = prev


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, in the operands' dtype."""
    return torch.matmul(x, w)


def contract(pattern: str, *args: torch.Tensor) -> torch.Tensor:
    """einsum, in the operands' dtype."""
    return torch.einsum(pattern, *args)
