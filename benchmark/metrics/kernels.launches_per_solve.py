"""Launches of the hand-written kernels that ran on the card (the
program's ``kernel_launches``: through the wrappers, plus those graph
replays ran, less those a capture recorded) per answer of the traced
span."""

from benchmark import spanlog


def read(record):
    return spanlog.count_per_answer(record, "kernel_launches")
