"""The device's peak of allocated memory over the window
(torch.cuda.max_memory_allocated, reset once set-up is done)."""


def read(run):
    return run["peak_bytes"] / 2**30 if run["peak_bytes"] else None
