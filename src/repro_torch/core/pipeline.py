"""Two-stage producer-consumer pipeline timing (ZNNi §VII-C).

Only the steady-state cadence the planner prices is ported so far; the
executed pipeline (``pipelined_apply``) waits for its slice.
"""

from __future__ import annotations


def steady_state_time(t_stage0: float, t_stage1: float, t_xfer: float = 0.0) -> float:
    """Per-patch cadence of the queue-depth-1 pipeline (§VII-C).

    The slower stage bounds the rate; the hand-off is not overlapped with
    compute under queue depth 1, so it adds to every patch's cadence.
    This is the quantity ``planner.plan_hetero`` maximizes voxels over.
    """
    return max(t_stage0, t_stage1) + t_xfer
