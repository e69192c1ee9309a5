"""Receiver source fields added into adjoint sources at their entries
alone, as electric points (the program's ``rfield_point_receivers``
counter, over the iterates' roots) per iterate of the traced span."""

from benchmark import surveylog


def read(record):
    return surveylog.count_per_step(record, "rfield_point_receivers")
