"""Share of its roofline that ``line_phase`` reaches in the traced span:
the least time of the launches that ran (computed bytes of the frozen
``benchmark.roofline.line_phase_work`` at 3.35 TB/s, or operations at
67 TFLOP/s where larger) over their device time by kernel name.  The
launches are those the benchmark's hooks saw, each replay counting the
launches its graph recorded; when they do not match the kernels the
trace holds, nothing is read."""


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    line = prof["line_phase"]
    if not line["traced"] or line["traced"] != line["recorded"]:
        return None
    return 100.0 * line["bound_s"] / line["device_s"]
