"""Volume runtime: tile an arbitrary volume into patches and sweep a plan.

``tiler``    — patch geometry (FOV overlap, shifted edge patches), the
               sweep-cache simulations behind ``predict_sweep_counts``.
``executor`` — ``PlanExecutor``: the deployed overlap-save + deep-reuse
               sweep, with the device ledger.
"""

from .executor import PlanExecutor  # noqa: F401
from .tiler import (  # noqa: F401
    PatchSpec,
    VolumeTiling,
    extract_patch,
    pad_volume,
    tile_for_net,
    tile_volume,
)
