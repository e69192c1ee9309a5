"""Kernel launches through the wrappers of ``gs_phase`` and ``line_phase``
(``ops.gs_phase.LAUNCHES + ops.line_phase.LAUNCHES``) over the window
per lane solved.  A count of what passes the wrappers, not of what runs
on the card."""


def read(record):
    if not record["answers"]:
        return None
    return record["wrapper_launches"] / record["answers"]
