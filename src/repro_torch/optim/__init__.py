"""Optimizers and schedules (the port of ``repro.optim``)."""

from .adamw import (  # noqa: F401
    AdamWConfig,
    QTensor,
    adamw_state_from_numpy,
    apply_updates,
    global_norm,
    init_state,
)
from . import tree  # noqa: F401
from .schedule import cosine_warmup  # noqa: F401
