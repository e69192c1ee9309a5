"""Host milliseconds of the adjoint source fields (``emg3d.sim.rfield``
spans: each receiver's source field on the full computational grid,
summed into its source's adjoint source) per iterate of the traced
span."""

from benchmark import surveylog


def read(record):
    return surveylog.ms_per_step(record, "emg3d.sim.rfield")
