"""Batched inference engines (continuous batching).

``engine``        — LM serving: token-level continuous batching over slots.
``volume_engine`` — 3D volume serving: patch-level continuous batching
                    across queued volumes, driven by a planner Plan.
"""

from .engine import EngineConfig, Request, ServingEngine  # noqa: F401
from .volume_engine import VolumeEngine, VolumeRequest  # noqa: F401
