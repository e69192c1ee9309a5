"""Models volume-averaged onto a task's computational grid (the
program's ``sim_models`` counter, over the steps' roots) per step of
the traced span."""

from benchmark import surveyroots


def read(record):
    return surveyroots.count_per_step(record, "sim_models")
