"""Distribution substrate of the single-process sharded fleet.

``collectives``     — the boundary ``HaloPackage`` a sweep shard hands its
                      successor, and ``halo_exchange``.
``fault_tolerance`` — ``HeartbeatMonitor`` (failure and straggler
                      detection on a caller-supplied clock) and
                      ``elastic_shard_sizes``.
"""

from . import collectives, fault_tolerance  # noqa: F401
