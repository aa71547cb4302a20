"""The device (H100): ``torch.cuda.max_memory_allocated`` over the window, in
GiB (the allocator's own counter)."""


def read(run):
    return run["peak_bytes"] / 2**30 if run["peak_bytes"] else None
