"""Milliseconds inside the solves (the outermost ``emg3d.solve`` spans
inside the iterates: hierarchies, copies and cycles, forward and
adjoint) per iterate of the traced span."""

from benchmark import surveylog


def read(record):
    return surveylog.ms_per_step(record, "emg3d.solve")
