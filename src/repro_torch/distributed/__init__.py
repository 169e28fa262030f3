"""Distribution substrate: the sharded fleet and the process groups.

``collectives``     — the boundary ``HaloPackage`` a sweep shard hands its
                      successor, and ``halo_exchange``.
``fault_tolerance`` — ``HeartbeatMonitor`` (failure and straggler
                      detection on a caller-supplied clock) and
                      ``elastic_shard_sizes``.
``host_group``      — process groups over ``torch.distributed`` (gloo),
                      every hand-off through host memory and counted.
"""

from . import collectives, fault_tolerance, host_group  # noqa: F401
