"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read.

Device activity is every event of the categories in ``DEVICE`` (kernels,
copies, memsets), launched one by one or replayed in a CUDA graph.  The
traced window is the benchmark's own ``record_function`` span
(``SPAN``).  Inside it:

- ``busy_s``: the union of the device intervals (overlaps counted once);
- ``by_name``: count and seconds of each device operation;
- ``h2d_s``: seconds of host-to-device copies;
- ``idle``: the window's idle time split by what the host was doing: the
  innermost host event (an operator or a runtime call) open on the
  span's thread; where none is (Python and NumPy work), the program's
  function that the nearest sample of the stack sampler (``samples``,
  seconds from the span's start) saw, within ``NEAREST_S``; else
  ``HOST_ONLY``.
"""

import bisect
import collections
import json

SPAN = "benchmark.span"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
HOST_ONLY = "host code outside any traced operator"
NEAREST_S = 0.01


def load(path):
    """The complete ("X") events of a chrome trace file."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_segments(events, lo, hi):
    """(start, end, label) pieces of [lo, hi] labelled with the innermost
    open host event; events nest on one thread."""
    segments, stack, cur = [], [], lo

    def emit(end, label):
        nonlocal cur
        end = min(end, hi)
        if end > cur:
            segments.append((cur, end, label))
            cur = end

    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        s = max(float(e["ts"]), lo)
        while stack and stack[-1][0] <= s:
            emit(*stack.pop())
        emit(s, stack[-1][1] if stack else HOST_ONLY)
        stack.append((float(e["ts"]) + float(e["dur"]), e["name"]))
    while stack:
        emit(*stack.pop())
    emit(hi, HOST_ONLY)
    return segments


def _idle_pieces(busy, segments):
    """(start, end, label) of the parts of the host segments in which the
    device ran nothing; ``busy`` merged and sorted."""
    starts = [b[0] for b in busy]
    for s, t, label in segments:
        cur = s
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < t:
            if busy[i][1] > cur:
                if busy[i][0] > cur:
                    yield cur, busy[i][0], label
                cur = max(cur, busy[i][1])
            i += 1
        if cur < t:
            yield cur, t, label


def summarize(events, samples=()):
    """The window's numbers (seconds), or None without a ``SPAN`` event."""
    spans = [e for e in events if e["name"] == SPAN]
    if not spans:
        return None
    span = spans[-1]
    lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])

    device = [e for e in events if e.get("cat") in DEVICE
              and float(e["ts"]) < hi
              and float(e["ts"]) + float(e["dur"]) > lo]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    h2d = 0.0
    clipped = []
    for e in device:
        s = max(float(e["ts"]), lo)
        t = min(float(e["ts"]) + float(e["dur"]), hi)
        clipped.append((s, t))
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += (t - s) * 1e-6
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]:
            h2d += (t - s) * 1e-6
    busy = _union(clipped)

    host = [e for e in events if e.get("cat") in HOST and e["name"] != SPAN
            and e.get("tid") == span.get("tid")
            and e.get("pid") == span.get("pid")
            and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    times = [lo + 1e6 * t for t, _ in samples]
    idle = collections.defaultdict(float)
    for s, t, label in _idle_pieces(busy, _host_segments(host, lo, hi)):
        if label == HOST_ONLY and samples:
            i, j = (bisect.bisect_left(times, x) for x in (s, t))
            if j > i:
                for _, name in samples[i:j]:
                    idle[name] += (t - s) * 1e-6 / (j - i)
                continue
            near = min((k for k in (i - 1, i) if 0 <= k < len(times)),
                       key=lambda k: abs(times[k] - (s + t) / 2))
            if abs(times[near] - (s + t) / 2) <= 1e6 * NEAREST_S:
                label = samples[near][1]
        idle[label] += (t - s) * 1e-6

    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "by_name": {k: tuple(v) for k, v in by_name.items()},
        "h2d_s": h2d,
        "idle": dict(idle),
    }


def top(pairs, n=10):
    """The ``n`` largest (name, seconds) of a mapping, largest first."""
    return [[k[:200], v] for k, v in
            sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]
