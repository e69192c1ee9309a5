"""Tasks whose gradient was mapped from their computational grid back to
the model's grid (the program's ``gradient_regrid_tasks`` counter, over
the iterates' roots) per iterate of the traced span."""

from benchmark import surveylog


def read(record):
    return surveylog.count_per_step(record, "gradient_regrid_tasks")
