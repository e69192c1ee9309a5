"""Host milliseconds of the hierarchies' builds (``emg3d.hierarchy.build``
spans: the model's restriction and the levels' copies to the card
included) per answer of the traced span."""

from benchmark import spanlog


def read(record):
    return spanlog.ms_per_answer(record, "emg3d.hierarchy.build")
