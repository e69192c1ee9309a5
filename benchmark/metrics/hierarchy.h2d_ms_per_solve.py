"""Milliseconds of host-to-device copies on the device per answer of the
traced span (the profiler's copy events)."""


def read(record):
    prof = record.get("profile")
    if not prof or not prof["answers"] or not prof["busy_s"]:
        return None
    return 1e3 * prof["h2d_s"] / prof["answers"]
