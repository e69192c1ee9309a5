"""Host reads of device values (the program's ``host_syncs`` counter:
Krylov inner products and norms, the cycles' residual norms, the batch's
lane norms) per answer of the traced span."""

from benchmark import spanlog


def read(record):
    return spanlog.count_per_answer(record, "host_syncs")
