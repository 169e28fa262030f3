"""The comparison that decides ``correct``.

Each answer the timed path produced (a whole block, or a whole request) is
held against the plain reference's dense output of the same volume under
the same weights.  Its reading is the largest absolute difference over
the answer's voxels, as a share of the reference's largest absolute
output; a run reads the worst answer.  A missing or non-finite answer
reads infinity.
"""

from __future__ import annotations

import math

import numpy as np


def relative_error(got, want: np.ndarray) -> float:
    if got is None or got.shape != want.shape:
        return math.inf
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    worst = float(diff.max())
    if not math.isfinite(worst):
        return math.inf
    return worst / max(float(np.abs(want).max()), 1e-30)
