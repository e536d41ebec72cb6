"""Seconds from the start of the process to the first timed job: imports,
CUDA's start, the kernels' build (a checkout's first run), the input made
and packed, and the warm-up job."""


def read(run):
    return run["setup_s"]
