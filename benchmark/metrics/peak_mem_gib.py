"""``torch.cuda.max_memory_allocated()`` over set-up and the window, in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
