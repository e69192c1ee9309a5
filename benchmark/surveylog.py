"""The program's span log of a survey's iterates, as the readers of the
survey layer's spans and counters read it.

An answer of a survey cell is one ``emg3d.sim.gradient`` root: one
inversion iterate (:mod:`benchmark.entries.gradient`).  The benchmark's
profiler runs only over the traced span (``harness._profiled_span``), so
after a traced run the log holds that span's iterates and nothing else.
A root's ``attrs["counts"]`` holds how much each of the program's
counters grew while it was open.  A program without the module or
without the survey layer's spans, an empty log, a log that dropped
spans, or one whose roots differ from the traced span's answers reads
nothing.
"""

GRADIENT = "emg3d.sim.gradient"


def read_log(record):
    """(spans, roots) of the traced span's log, or None."""
    prof = record.get("profile")
    if not prof:
        return None
    try:
        from emg3d_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    roots = [s for s in spans if s.parent is None and s.name == GRADIENT]
    if not roots or len(roots) != prof["answers"] or tracing.dropped():
        return None
    return spans, roots


def ms_per_step(record, name):
    """Milliseconds of the spans named ``name`` inside the roots, per
    iterate; for the solves (``emg3d.solve``), only the outermost."""
    log = read_log(record)
    if log is None:
        return None
    spans, roots = log
    ids = {r.id for r in roots}
    if name == "emg3d.solve":
        from emg3d_tpu_torch import tracing
        spans = tracing.roots()
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name == name and s.root in ids)
    return 1e-6 * ns / len(roots)


def count_per_step(record, counter):
    """The growth of ``counter`` over the roots, per iterate."""
    log = read_log(record)
    if log is None:
        return None
    _, roots = log
    if any(counter not in r.attrs["counts"] for r in roots):
        return None
    return sum(r.attrs["counts"][counter] for r in roots) / len(roots)
