"""True dense output voxels finalized in the window over its seconds: a
block's voxel counts once its output row is final, so a block part done at
either end of the window counts what finished inside it; padding never
counts."""


def read(run):
    if run.voxels <= 0 or run.window_s <= 0:
        return None
    return run.voxels / run.window_s
