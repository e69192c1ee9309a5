"""Host milliseconds of the computational grids' construction
(``emg3d.sim.grid`` spans: ``meshes.construct_mesh`` for each sharing
unit of the gridding) per step of the traced span."""

from benchmark import surveyroots


def read(record):
    return surveyroots.ms_per_step(record, "emg3d.sim.grid", "sim_grids")
