"""Distribution substrate: the sharded fleet and the process groups.

``collectives``     — the boundary ``HaloPackage`` a sweep shard hands its
                      successor, ``halo_exchange``, and the training
                      collectives (ring all-gather matmul, chunked
                      all-gather, compressed mean, reduce-scatter mean).
``fault_tolerance`` — ``HeartbeatMonitor`` (failure and straggler
                      detection on a caller-supplied clock) and
                      ``elastic_shard_sizes``, and ``restore_with_remesh``.
``host_group``      — process groups over ``torch.distributed`` (gloo),
                      every hand-off through host memory and counted.
``sharding``        — the reference's name-based sharding rules, read by
                      the dry run (``launch/dryrun.py``).
``constraints``     — the reference's activation constraints, no-ops here.
"""

from . import collectives, constraints, fault_tolerance, host_group, sharding  # noqa: F401
