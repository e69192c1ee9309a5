"""Multigrid cycles (``it_mg`` of each solve's info; of the batch for each
of its lanes) per answer of the window."""


def read(record):
    cycles = record["cycles"]
    return sum(cycles) / len(cycles) if cycles else None
