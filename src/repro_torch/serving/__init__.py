"""Batched inference engines (continuous batching).

``volume_engine`` — 3D volume serving: patch-level continuous batching
                    across queued volumes, driven by a planner Plan.
"""

from .volume_engine import VolumeEngine, VolumeRequest  # noqa: F401
