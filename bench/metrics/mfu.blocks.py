"""The whole step's share of the card's peak: the net's direct sliding-window
operations per dense output voxel times the traced run's voxels a second,
over the H100 SXM's published dense TF32 rate, in %.  The count depends
only on the net, so it is the same work whatever computes it."""

import work


def read(run):
    if run.voxels <= 0 or run.window_s <= 0 or run.device.type != "cuda":
        return None
    return 100.0 * run.flops_per_voxel * run.voxels / run.window_s / work.PEAK_TF32
