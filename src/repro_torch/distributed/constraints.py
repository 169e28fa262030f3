"""Activation sharding constraints, the reference's
``repro.distributed.constraints``.

In the reference, ``constrain`` pins an activation's sharding with
``with_sharding_constraint`` under logical axis names ('batch' ->
('pod', 'data'), 'model', 'seq' -> 'model'), so that GSPMD does not
replicate it across a scan or checkpoint boundary, and degrades to a
no-op when no mesh is active.  The port has no GSPMD: it runs eagerly on
one card and never has an active mesh, so both functions return their
input unchanged, and the port's layers dropped the calls
(``layers/attention.py``).  They stay so that code written against the
reference's API runs unchanged.
"""

from __future__ import annotations

import torch


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    """Pin activation sharding; a no-op in the port (no mesh is active)."""
    return x


def constrain_replicated(x: torch.Tensor) -> torch.Tensor:
    """Pin a tensor fully replicated; a no-op in the port."""
    return x
