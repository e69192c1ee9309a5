"""Host milliseconds of the gradient's assembly
(``emg3d.sim.gradient.assemble`` spans: the products of forward and
adjoint fields, their cell averages, the transpose of the volume
averaging onto the inversion mesh and the mapping's chain rule) per
iterate of the traced span."""

from benchmark import surveylog


def read(record):
    return surveylog.ms_per_step(record, "emg3d.sim.gradient.assemble")
