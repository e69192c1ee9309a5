"""Host milliseconds of ``models.VolumeModel`` (eta and zeta of the
model, ``emg3d.model.volume`` spans) per answer of the traced span."""

from benchmark import spanlog


def read(record):
    return spanlog.ms_per_answer(record, "emg3d.model.volume")
