"""Megabytes (1e6 bytes) the program copied from the card to the host
(its ``d2h_bytes`` counter, over the solves' root spans) per answer of
the traced span."""

from benchmark import spanlog


def read(record):
    return spanlog.count_per_answer(record, "d2h_bytes", 1e-6)
