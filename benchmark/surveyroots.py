"""The program's span log of a survey cell's steps, as the readers of the
survey layer's grid and model counters read it, in every survey cell.

A step of a survey cell is one root of the survey layer: an
``emg3d.sim.gradient`` root where the step reads a gradient (one
inversion iterate, :mod:`benchmark.entries.gradient`; its forward
solves run inside it), else an ``emg3d.sim.compute`` root (one forward
evaluation, :mod:`benchmark.entries.forward`).  The benchmark's
profiler runs only over the traced span (``harness._profiled_span``),
so after a traced run the log holds that span's steps and nothing else.
A root's ``attrs["counts"]`` holds how much each of the program's
counters grew while it was open.  A program without the module or
without the counter read, an empty log, a log that dropped spans, or
one whose roots differ from the traced span's answers reads nothing.
"""

GRADIENT = "emg3d.sim.gradient"
COMPUTE = "emg3d.sim.compute"


def read_log(record, counter):
    """(spans, roots) of the traced span's log, or None; ``counter`` has
    to be in every root's counts."""
    prof = record.get("profile")
    if not prof:
        return None
    try:
        from emg3d_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    outer = [s for s in spans if s.parent is None]
    roots = [s for s in outer if s.name == GRADIENT] or [
        s for s in outer if s.name == COMPUTE]
    if not roots or len(roots) != prof["answers"] or tracing.dropped():
        return None
    if any(counter not in r.attrs["counts"] for r in roots):
        return None
    return spans, roots


def ms_per_step(record, name, counter):
    """Milliseconds of the spans named ``name`` inside the roots, per
    step, where the program counts ``counter`` beside them."""
    log = read_log(record, counter)
    if log is None:
        return None
    spans, roots = log
    ids = {r.id for r in roots}
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name == name and s.root in ids)
    return 1e-6 * ns / len(roots)


def count_per_step(record, counter):
    """The growth of ``counter`` over the roots, per step."""
    log = read_log(record, counter)
    if log is None:
        return None
    _, roots = log
    return sum(r.attrs["counts"][counter] for r in roots) / len(roots)
