"""Atomic, async checkpointing (the port of ``repro.checkpoint``)."""

from .ckpt import latest_step, prune_old, restore, save  # noqa: F401
