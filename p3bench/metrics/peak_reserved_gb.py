"""The most device memory the caching allocator held over the run, its
captured programs' pools included (torch.cuda.max_memory_reserved), GB."""


def read(run):
    return run.peak_reserved_bytes / 1e9 if run.peak_reserved_bytes else None
