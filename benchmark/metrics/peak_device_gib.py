"""peak_device_gib: torch.cuda.max_memory_allocated() over the window,
in GiB (the peak statistics are reset when the window opens)."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
