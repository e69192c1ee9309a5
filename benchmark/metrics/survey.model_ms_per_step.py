"""Host milliseconds of the tasks' models (``emg3d.sim.model`` spans: the
inversion mesh's model volume-averaged onto a task's computational
grid, once per forward and per adjoint task) per iterate of the traced
span."""

from benchmark import surveylog


def read(record):
    return surveylog.ms_per_step(record, "emg3d.sim.model")
