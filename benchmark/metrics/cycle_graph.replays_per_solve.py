"""``torch.cuda.CUDAGraph.replay`` calls per answer of the window, counted
by the benchmark's hook on PyTorch's class."""


def read(record):
    if record.get("replays") is None or not record["answers"]:
        return None
    return record["replays"] / record["answers"]
