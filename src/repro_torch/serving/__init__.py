"""Batched inference engines (continuous batching).

``engine``        — LM serving: token-level continuous batching over slots.
``volume_engine`` — 3D volume serving: patch-level continuous batching
                    across queued volumes, driven by a planner Plan.
``sharded_engine`` — the N-worker fleet: each sweep's planes (along its
                    sweep axis) partitioned across workers with boundary
                    halo handoff, heartbeat-driven re-dispatch on worker
                    failure.
"""

from .engine import EngineConfig, Request, ServingEngine  # noqa: F401
from .sharded_engine import ShardedVolumeEngine  # noqa: F401
from .volume_engine import VolumeEngine, VolumeRequest  # noqa: F401
