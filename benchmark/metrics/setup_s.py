"""Seconds from the process's start to the first timed step: imports,
the CUDA context, the inputs, the warm-up and its graph captures (and,
in a checkout's first run, the kernels' build)."""


def read(record):
    return record["setup_s"]
