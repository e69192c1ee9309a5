"""Host milliseconds of the fields' copies (``emg3d.fields.to_device``:
source and initial field to the card; ``emg3d.fields.to_host``: the
result back) per answer of the traced span."""

from benchmark import spanlog


def read(record):
    return spanlog.ms_per_answer(record, "emg3d.fields.to_device",
                                 "emg3d.fields.to_host")
