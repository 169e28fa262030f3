"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at its start), in GB: resident spectra and caches count,
since they are allocated."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 1e9
