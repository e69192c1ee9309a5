"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB
(2**30 bytes)."""


def read(record):
    return record["peak_bytes"] / 2 ** 30
