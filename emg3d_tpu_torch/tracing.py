"""Spans and counters of the solve path.

A ``torch.profiler`` session shows each span as a ``user_annotation``
event named ``emg3d.*``, on the clock of the kernels and copies it
issues: an idle stretch of the card lies under the span of the host work
that held it.  Within ``with recording():`` the same spans are kept
without the profiler.  In both cases every closed span is also appended
to an in-memory log (:func:`spans`; the oldest of more than
``MAX_SPANS`` are dropped and counted, :func:`dropped`).  With neither,
:func:`span` costs one C call and returns a shared object that does
nothing, and nothing is logged.

Spans (each ``emg3d.*``; a root is a span opened with none open on its
thread):

- ``solve`` (root, ``shape``): one ``solver.solve`` call;
- ``batch.solve`` (root, ``lanes``): one
  ``parallel.batch.solve_batch_fields`` call;
- ``model.volume``: ``models.VolumeModel`` (eta and zeta on the host);
- ``hierarchy.build`` (``sc_dir``): one hierarchy, built on the host and
  copied to the device; inside it ``hierarchy.restrict_model`` (the
  model restricted to the next level) and ``hierarchy.to_device`` (a
  level's tensors copied);
- ``fields.to_device`` and ``fields.to_host``: source and initial fields
  to the device, the result back;
- ``cycle.step`` (``replayed``): one multigrid cycle, a replay of its
  CUDA graph or operation by operation;
- ``sync``: one host read of device values.

A root also keeps, in ``attrs['counts']``, how much each of
:func:`counts` grew while it was open.

Counters (always on; :func:`count` adds to them): ``h2d_bytes``,
``h2d_copies`` (``solver._to_device``), ``d2h_bytes``, ``d2h_copies``
(``solver._to_host``), ``host_syncs`` (``solver._scalar``),
``hierarchy_builds``, ``step_misses`` and ``step_evictions`` (the
whole-cycle step cache), and the launches of the hand-written kernels
that graphs replay.  :func:`counts` reads them with the counters that
live in their modules (``solver.CYCLE_CAPTURES``, ``CYCLE_REPLAYS``,
``ops.gs_phase.LAUNCHES``, ``ops.line_phase.LAUNCHES``) under one set of
names; ``kernel_launches`` is what ran on the card: launches through the
wrappers, plus those that replays ran, less those a capture recorded.
"""

import collections
import contextlib
import itertools
import threading
import time

import torch

__all__ = ['span', 'recording', 'spans', 'roots', 'clear', 'dropped',
           'count', 'counts', 'wrapper_launches', 'Span', 'MAX_SPANS']

MAX_SPANS = 200_000

SOLVES = ('emg3d.solve', 'emg3d.batch.solve')
KERNELS = ('gs_phase', 'line_phase')
COUNTERS = ('h2d_bytes', 'h2d_copies', 'd2h_bytes', 'd2h_copies',
            'host_syncs', 'hierarchy_builds', 'step_misses',
            'step_evictions',
            *(f'{kind}_launches.{k}' for kind in ('replayed', 'captured')
              for k in KERNELS))

_profiler_enabled = torch._C._autograd._profiler_enabled
_RECORDING = 0
_LOG = collections.deque(maxlen=MAX_SPANS)
_DROPPED = 0
_IDS = itertools.count(1)
_LOCAL = threading.local()
_COUNTS = dict.fromkeys(COUNTERS, 0)


def _stack():
    """The open spans of this thread, innermost last."""
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class Span:
    """One span: ``name``, ``id``, ``parent`` (id, None for a root),
    ``root`` (the id of its root: one per solve), ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns()``) and ``attrs``."""

    __slots__ = ('name', 'id', 'parent', 'root', 'start_ns', 'end_ns',
                 'attrs', '_annotation', '_counts')

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.end_ns = None
        self._annotation = None
        self._counts = None

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9

    def set(self, **attrs):
        """Add attributes to the open span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        if parent is None:
            self._counts = counts()
        if _profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _DROPPED
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        if self._counts is not None:
            now = counts()
            self.attrs['counts'] = {k: now[k] - self._counts[k] for k in now}
            self._counts = None
        if len(_LOG) == MAX_SPANS:
            _DROPPED += 1
        _LOG.append(self)
        return False


class _Off:
    """The span while nothing records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def span(name, **attrs):
    """A context manager around the work it names: a :class:`Span` while
    ``torch.profiler`` records or within :func:`recording`, else a shared
    no-op."""
    if _RECORDING or _profiler_enabled():
        return Span(name, attrs)
    return _OFF


@contextlib.contextmanager
def recording():
    """Keep spans in the log within the block, without a profiler."""
    global _RECORDING
    _RECORDING += 1
    try:
        yield
    finally:
        _RECORDING -= 1


def spans():
    """The log: the closed spans, in the order they closed."""
    return list(_LOG)


def roots():
    """The solves' root spans in the log (``emg3d.solve`` and
    ``emg3d.batch.solve``)."""
    return [s for s in _LOG if s.parent is None and s.name in SOLVES]


def dropped():
    """Spans dropped from the log since the last :func:`clear`."""
    return _DROPPED


def clear():
    """Empty the log."""
    global _DROPPED
    _LOG.clear()
    _DROPPED = 0


def count(name, n=1):
    """Add ``n`` to the counter ``name`` (one of ``COUNTERS``)."""
    _COUNTS[name] += n


def wrapper_launches():
    """(gs_phase, line_phase) launches through the kernels' wrappers."""
    from emg3d_tpu_torch.ops import gs_phase, line_phase
    return gs_phase.LAUNCHES, line_phase.LAUNCHES


def counts():
    """A snapshot of every counter, under one set of names."""
    from emg3d_tpu_torch import solver

    out = dict(_COUNTS)
    out['cycle_captures'] = solver.CYCLE_CAPTURES
    out['cycle_replays'] = solver.CYCLE_REPLAYS
    for k, n in zip(KERNELS, wrapper_launches()):
        out[f'wrapper_launches.{k}'] = n
        out[f'launches.{k}'] = (n + out[f'replayed_launches.{k}']
                                - out[f'captured_launches.{k}'])
    out['replayed_launches'] = sum(out[f'replayed_launches.{k}']
                                   for k in KERNELS)
    out['kernel_launches'] = sum(out[f'launches.{k}'] for k in KERNELS)
    return out
