"""Seconds of the window per answer (a solve, or a lane of a batched
solve): all the work and all the time of the window, every step ending
in ``torch.cuda.synchronize()``."""


def read(record):
    if not record["answers"]:
        return None
    return record["window_s"] / record["answers"]
