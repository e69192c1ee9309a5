"""The program's own span log, as the readers of its spans and counters
read it.

``emg3d_tpu_torch.tracing`` logs every span that closes while
``torch.profiler`` records.  The benchmark's profiler runs only over the
traced span (``harness._profiled_span``), so after a traced run the log
holds that span's steps and nothing else.  An answer is one
``emg3d.solve`` root or one lane of an ``emg3d.batch.solve`` root (its
``lanes``); a root's ``attrs["counts"]`` holds how much each of the
program's counters grew while it was open.  A program without the
module, an empty log, a log that dropped spans, or one whose answers
differ from the traced span's reads nothing.
"""

SOLVE = "emg3d.solve"
BATCH = "emg3d.batch.solve"


def read_log(record):
    """(spans, roots, answers) of the traced span's log, or None."""
    prof = record.get("profile")
    if not prof:
        return None
    try:
        from emg3d_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    roots = [s for s in spans
             if s.parent is None and s.name in (SOLVE, BATCH)]
    answers = sum(1 if s.name == SOLVE else s.attrs["lanes"] for s in roots)
    if not answers or answers != prof["answers"] or tracing.dropped():
        return None
    return spans, roots, answers


def ms_per_answer(record, *names):
    """Milliseconds of the spans named ``names`` (children included) per
    answer."""
    log = read_log(record)
    if log is None:
        return None
    spans, _, answers = log
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name in names)
    return 1e-6 * ns / answers


def count_per_answer(record, counter, scale=1.0):
    """``scale`` times the growth of ``counter`` over the roots, per
    answer."""
    log = read_log(record)
    if log is None:
        return None
    _, roots, answers = log
    return scale * sum(r.attrs["counts"][counter] for r in roots) / answers
