"""torch.cuda.max_memory_allocated() over the run, set-up included (the
graph pools are allocated at capture), in GB; the benchmark's generator
buffers are freed and the peak reset before the system is built."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
