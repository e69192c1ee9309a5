"""Receiver source fields summed into adjoint sources (the program's
``rfield_receivers`` counter, over the iterates' roots) per iterate of
the traced span."""

from benchmark import surveylog


def read(record):
    return surveylog.count_per_step(record, "rfield_receivers")
