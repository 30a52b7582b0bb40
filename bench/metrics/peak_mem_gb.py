"""peak_mem_gb: the card's peak of allocated memory over the program's
set-up and the window (``torch.cuda.max_memory_allocated``, reset after
the benchmark made its tensor), in 1e9 bytes."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e9
