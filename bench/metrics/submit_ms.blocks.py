"""Host milliseconds inside ``VolumeEngine.submit`` per block (bucketing,
padding, tiling), timed by the harness, the mean over the blocks
submitted in the window."""


def read(run):
    if not run.submit_s:
        return None
    return 1e3 * sum(run.submit_s) / len(run.submit_s)
