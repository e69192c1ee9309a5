"""1 - busy / window of the traced span: busy is the union of the
device's kernels, copies and memsets in the profiler's trace."""


def read(record):
    prof = record.get("profile")
    if not prof or not prof["busy_s"]:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
