"""``torch.cuda.max_memory_allocated()`` over the program's set-up and the
window, in GiB (the benchmark's own inputs are made before the reset)."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2**30
