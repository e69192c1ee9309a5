"""Megabytes (1e6 bytes) the program copied from the host to the card
(its ``h2d_bytes`` counter, over the solves' root spans) per answer of
the traced span."""

from benchmark import spanlog


def read(record):
    return spanlog.count_per_answer(record, "h2d_bytes", 1e-6)
