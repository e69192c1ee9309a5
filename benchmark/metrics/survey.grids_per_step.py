"""Computational grids constructed (the program's ``sim_grids`` counter,
over the steps' roots) per step of the traced span."""

from benchmark import surveyroots


def read(record):
    return surveyroots.count_per_step(record, "sim_grids")
