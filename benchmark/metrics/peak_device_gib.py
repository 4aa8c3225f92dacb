"""torch.cuda.max_memory_allocated() over set-up and window (reset at the
run's start, read when the window closes), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
