"""Two-stage producer-consumer pipeline — ZNNi's CPU-GPU execution (§VII-C).

The paper splits the net at layer θ: one device computes layers [0, θ)
for patch t while the other computes layers [θ, L) for patch t-1, with a
queue of depth 1 (the producer stalls until the consumer drains).

``pipeline_schedule`` simulates that queue-depth-1 timeline (for tests and
the Fig. 8 analysis); ``pipelined_apply`` runs it over a patch stream, in
one process or as a ring over a ``torch.distributed`` process group (one
stage hand-off per step, through host memory); ``make_stage_fns`` binds
the two stages to a compiled plan; ``hetero_stage_devices`` says where
each stage of a ``hetero`` plan runs.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..distributed.host_group import exchange, group_rank, group_size
from .hw import is_host_cpu


def steady_state_time(t_stage0: float, t_stage1: float, t_xfer: float = 0.0) -> float:
    """Per-patch cadence of the queue-depth-1 pipeline (§VII-C).

    The slower stage bounds the rate; the hand-off is not overlapped with
    compute under queue depth 1, so it adds to every patch's cadence.
    This is the quantity ``planner.plan_hetero`` maximizes voxels over.
    """
    return max(t_stage0, t_stage1) + t_xfer


def hetero_stage_devices(
    profiles: Sequence[str], device: torch.device
) -> Tuple[torch.device, torch.device]:
    """The devices the two stages of a hetero plan run on.

    ``profiles`` is the plan's ``devices``: the profile name each stage
    was priced on, stage 0 first.  A stage priced on a host-CPU profile
    (``hw.is_host_cpu``) runs on the CPU with the plain versions; the
    other runs on ``device``, the executor's, with the kernels.
    ``plan_hetero`` tries both stage orders, so either stage may be the
    CPU's; when ``profiles[0]`` is the host CPU this is the reference's
    fixed placement (stage 0 on the host, stage 1 on the accelerator).
    """
    if len(profiles) != 2:
        raise ValueError(f"a hetero plan has two stage profiles, got {profiles!r}")
    cpu = torch.device("cpu")
    return tuple(cpu if is_host_cpu(p) else torch.device(device) for p in profiles)


def pipeline_schedule(
    n_patches: int, t_stage0: float, t_stage1: float, t_xfer: float = 0.0
) -> Tuple[float, List[Tuple[str, int, float, float]]]:
    """Simulate the paper's queue-depth-1 schedule.

    Returns (makespan, events) with events (stage, patch, start, end).
    Producer may only start patch t+1 once the consumer has *picked up*
    patch t (queue empty), per §VII-C.
    """
    events = []
    prod_free = 0.0
    cons_free = 0.0
    queue_free = 0.0  # time the queue becomes empty again
    for t in range(n_patches):
        s0 = max(prod_free, queue_free)
        e0 = s0 + t_stage0
        events.append(("stage0", t, s0, e0))
        # hand-off: consumer picks up when free; queue empties at pickup
        pickup = max(e0 + t_xfer, cons_free)
        queue_free = pickup
        e1 = pickup + t_stage1
        events.append(("stage1", t, pickup, e1))
        cons_free = e1
        prod_free = e0
    return cons_free, events


def pipelined_apply(
    stage0: Callable, stage1: Callable, xs: torch.Tensor, *, group=None
) -> torch.Tensor:
    """Run stage0 → stage1 over a stream of patches ``xs`` (T, ...).

    With no process group (none initialized, or a group of one) this is
    the queue-depth-1 loop in one process: step t applies stage 1 to the
    stage-0 activation of step t-1 (the one-slot queue) and stage 0 to
    patch t; the outputs come back stacked in patch order.

    With n ranks in ``group`` it is the reference's ring over the ``pod``
    mesh axis: ``xs`` is this rank's local stream, the stage-0 output of
    step t goes to rank (r+1) % n, which applies stage 1 at step t+1 (the
    first slot is the fill bubble).  The returned stream is stage 1 of
    the PREVIOUS rank's patches, aligned to that rank's steps; the caller
    realigns (``PlanExecutor._run_pipeline`` rolls the gathered streams
    by one local-stream length).  Every hand-off goes through host memory
    (``distributed.host_group.exchange``), counted in bytes.
    """
    n, r = group_size(group), group_rank(group)

    def hand_off(a):  # to the next rank; receive from the previous one
        return a if n == 1 else exchange(a, (r + 1) % n, a, (r - 1) % n, group)

    a = hand_off(stage0(xs[0]))
    ys = []
    for x in xs[1:]:
        ys.append(stage1(a))  # the consumer drains patch t-1 ...
        a = hand_off(stage0(x))  # ... while the producer fills the slot with patch t
    ys.append(stage1(a))
    return torch.stack(ys)


def split_net_at_theta(
    prims: Sequence[str], theta: int
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Layer indices for stage 0 ([0, θ)) and stage 1 ([θ, L))."""
    idx = tuple(range(len(prims)))
    return idx[:theta], idx[theta:]


def make_stage_fns(compiled, theta: int, *, states=None) -> Tuple[Callable, Callable]:
    """Stage closures for a pipeline2 plan: layers [0, θ) and [θ, L).

    ``compiled`` is a ``primitives.CompiledPlan``: both stages walk its
    prepared layers, so per-layer setup (cached kernel spectra, chosen FFT
    shapes) is shared with every other consumer of the plan.  ``states``
    substitutes the prepared states (another device's copy).  Neither
    stage recombines MPF fragments — the executor folds fragments back
    after stage 1 (recombination needs all pools, which may straddle the
    split).  ``stage1 ∘ stage0 == compiled.apply(..., recombine=False)``.
    """

    def stage0(x):
        return compiled.apply_range(x, 0, theta, states=states)

    def stage1(x):
        return compiled.apply_range(x, theta, None, states=states)

    return stage0, stage1
