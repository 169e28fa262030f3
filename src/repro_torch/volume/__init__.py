"""Volume runtime: tile an arbitrary volume into patches and sweep a plan.

``tiler``    — patch geometry (FOV overlap, shifted edge patches), the
               sweep-cache simulations behind ``predict_sweep_counts``.
``executor`` — ``PlanExecutor``: the dense walk of any plan (MPF or the
               plain-pool subsampling sweep) and the overlap-save +
               deep-reuse sweep, with the device ledger; ``tiled_apply``
               for one-shot use.
"""

from .executor import PlanExecutor, tiled_apply  # noqa: F401
from .tiler import (  # noqa: F401
    PatchSpec,
    VolumeTiling,
    extract_patch,
    pad_volume,
    tile_for_net,
    tile_volume,
)
