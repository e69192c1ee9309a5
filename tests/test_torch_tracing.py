"""PyTorch port, spans and counters (``emg3d_tpu_torch.tracing``) on the CPU.

Solves at 16^3 with ``device='cpu'`` (loose tolerances and V-cycles
keep the file to a few seconds):

- with no profiler and no ``recording()`` a solve enters no
  ``record_function`` and logs nothing, and the counters still count;
- a solve of the default solver (BiCGSTAB with semicoarsening cycling)
  under ``torch.profiler`` logs one ``emg3d.solve`` root, every other
  span inside its parent's interval and carrying the root's id, one
  ``emg3d.hierarchy.build`` per semicoarsening direction, and each span
  name as a ``user_annotation`` event of the chrome trace;
  ``recording()`` logs the same spans without the profiler.  Point
  smoothing, two levels, V-cycles with one pre- and post-smoothing: the
  profiler records every operation of the plain smoothers, some 750,000
  events (30 s) for one default cycle at 16^3;
- ``h2d_bytes`` and ``d2h_bytes`` equal the bytes of the level and field
  tensors, reckoned from the grid;
- ``host_syncs`` (one ``emg3d.sync`` span each) equals ``1 + it_mg`` for
  plain multigrid and ``1 + 2 it_mg + 2 it_ssl`` for BiCGSTAB with a
  one-cycle preconditioner;
- ``EMG3D_TPU_CYCLE_JIT=1`` with a step cache of one counts its misses
  and evictions;
- a 2-lane ``solve_batch_fields`` is one ``emg3d.batch.solve`` root with
  ``lanes=2``;
- every counter of ``tracing.COUNTERS`` but the kernels' replayed and
  captured launches (among them the survey layer's ``sim_grids`` and
  ``sim_models``) is named in the module's docstring, and so is every
  span of the survey layer.
"""

import collections
import json

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu_torch import solver, tracing

N = 16
NAMES = {'emg3d.solve', 'emg3d.model.volume', 'emg3d.hierarchy.build',
         'emg3d.hierarchy.restrict_model', 'emg3d.hierarchy.to_device',
         'emg3d.fields.to_device', 'emg3d.fields.to_host',
         'emg3d.cycle.step', 'emg3d.sync'}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def problem():
    grid = t3.TensorMesh([np.ones(N) * 50.0] * 3, origin=(-400.,) * 3)
    model = t3.Model(grid, property_x=1.0, property_y=2.0, property_z=5.0,
                     mapping='Resistivity')
    return model, t3.get_source_field(grid, (0., 0., 0., 0., 0.), 1.0)


def recorded(problem, **kwargs):
    """(info, spans) of a solve within ``recording()``."""
    tracing.clear()
    with tracing.recording():
        _, info = t3.solve(*problem, device='cpu', return_info=True,
                           **kwargs)
    return info, tracing.spans()


def root_counts(spans):
    (root,) = [s for s in spans if s.parent is None]
    return root.attrs['counts']


def field_bytes(n, item=16):
    """The three edge components of an n^3 grid."""
    return 3 * n * (n + 1) ** 2 * item


def hierarchy_bytes(n, item=16, ritem=8):
    """One standard-coarsening hierarchy of an n^3 uniform grid down to
    2^3: per level eta (3 n^3), zeta (n^3) and widths (3 n); per
    transfer three restriction weights of n/2 + 1 coarse nodes and the
    prolongation's index and weight of n + 1 fine nodes, per axis."""
    total = 0
    while True:
        total += 3 * n ** 3 * item + n ** 3 * ritem + 3 * n * ritem
        if n == 2:
            return total
        total += 3 * (3 * (n // 2 + 1) * ritem + 2 * (n + 1) * 8)
        n //= 2


def test_off_logs_nothing_and_counts(problem, monkeypatch):
    def entered(*args, **kwargs):
        raise AssertionError('record_function entered with tracing off')

    monkeypatch.setattr(torch.profiler, 'record_function', entered)
    tracing.clear()
    before = tracing.counts()
    t3.solve(*problem, device='cpu', plain=True, cycle='V', maxit=1)
    after = tracing.counts()
    assert tracing.spans() == [] and tracing.roots() == []
    assert tracing.span('emg3d.solve') is tracing.span('emg3d.sync')
    assert after['host_syncs'] - before['host_syncs'] == 2
    assert after['h2d_bytes'] > before['h2d_bytes']
    # Two norms and the three components of the field, its split parts
    # summed on the device.
    assert after['d2h_copies'] - before['d2h_copies'] == 5


# The default solver with point smoothing on two levels.
DEFAULT = dict(linerelaxation=False, cycle='V', clevel=1, nu_pre=1,
               nu_post=1, tol=1e-1)


@pytest.fixture(scope='module')
def default_logs(problem, tmp_path_factory):
    """A solve of the default solver under a CPU profiler and within
    ``recording()``: (info, spans, chrome trace events) each."""
    from torch.profiler import ProfilerActivity, profile

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = t3.solve(*problem, device='cpu', return_info=True,
                           **DEFAULT)
    path = tmp_path_factory.mktemp('trace') / 'chrome.json'
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    profiled = (info, tracing.spans(), events)
    return profiled, recorded(problem, **DEFAULT) + (None,)


def test_profiled_solve_spans(default_logs):
    info, spans, events = default_logs[0]
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ['emg3d.solve']
    assert roots[0].attrs['shape'] == (N, N, N)
    byid = {s.id: s for s in spans}
    for s in spans:
        assert s.root == roots[0].id and s.end_ns >= s.start_ns
        if s.parent is not None:
            p = byid[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert {s.name for s in spans} == NAMES
    builds = [s.attrs['sc_dir'] for s in spans
              if s.name == 'emg3d.hierarchy.build']
    assert len(builds) == len(set(builds)) >= 2
    assert set(builds) <= {1, 2, 3}
    counts = roots[0].attrs['counts']
    assert counts['hierarchy_builds'] == len(builds)
    names = collections.Counter(s.name for s in spans)
    assert counts['host_syncs'] == names['emg3d.sync']
    assert names['emg3d.cycle.step'] == info['it_mg']
    annotated = {e['name'] for e in events
                 if e.get('cat') == 'user_annotation'}
    assert NAMES <= annotated


def test_recording_logs_the_same(default_logs):
    (pinfo, pspans, _), (info, spans, _) = default_logs

    def shape(log):
        byid = {s.id: s for s in log}
        return sorted((s.name, None if s.parent is None
                       else byid[s.parent].name) for s in log)

    assert info['it_mg'] == pinfo['it_mg']
    assert shape(spans) == shape(pspans)
    assert root_counts(spans) == root_counts(pspans)


def test_plain_multigrid_counts(problem):
    info, spans = recorded(problem, plain=True, cycle='V', maxit=2)
    counts = root_counts(spans)
    syncs = 1 + info['it_mg']
    assert counts['host_syncs'] == syncs
    assert counts['h2d_bytes'] == hierarchy_bytes(N) + 2 * field_bytes(N)
    # The field back (its split parts summed on the device), and a
    # float64 norm per sync.
    assert counts['d2h_bytes'] == field_bytes(N) + 8 * syncs
    assert counts['hierarchy_builds'] == 1


def test_bicgstab_counts(problem):
    # One cycle a preconditioner: none of its norms is read.
    info, spans = recorded(problem, semicoarsening=False,
                           linerelaxation=False, cycle='V', tol=1e-2)
    counts = root_counts(spans)
    assert info['it_ssl'] >= 1
    assert counts['host_syncs'] == 1 + 2 * info['it_mg'] + 2 * info['it_ssl']
    assert counts['h2d_bytes'] == hierarchy_bytes(N) + 2 * field_bytes(N)
    assert counts['d2h_bytes'] > field_bytes(N)


def test_step_cache_counts(problem, monkeypatch):
    monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', '1')
    monkeypatch.setattr(solver, '_MAX_STEPS', 1)
    solver._STEPS.clear()
    try:
        # Semicoarsening cycles 1, 2, 3: each cycle is another step.
        info, spans = recorded(problem, sslsolver=False, cycle='V',
                               linerelaxation=False, maxit=3)
    finally:
        solver._STEPS.clear()
    counts = root_counts(spans)
    assert info['it_mg'] == 3
    assert counts['step_misses'] == 3 and counts['step_evictions'] == 2
    assert counts['cycle_captures'] == 3 and counts['kernel_launches'] == 0
    steps = [s for s in spans if s.name == 'emg3d.cycle.step']
    assert len(steps) == 3 and not any(s.attrs['replayed'] for s in steps)


def test_batch_root(problem):
    model, sfield = problem
    tracing.clear()
    with tracing.recording():
        t3.solve_batch_fields(model, [sfield, sfield], device='cpu',
                              cycle='V', maxit=1)
    (root,) = tracing.roots()
    assert root.name == 'emg3d.batch.solve' and root.attrs['lanes'] == 2
    assert root.attrs['counts']['hierarchy_builds'] == 1
    assert root.attrs['counts']['d2h_bytes'] >= 2 * field_bytes(N)
    assert {s.root for s in tracing.spans()} == {root.id}


SURVEY_SPANS = ('sim.compute', 'sim.responses', 'sim.misfit', 'sim.gradient',
                'sim.bcompute', 'sim.rfield', 'sim.gradient.assemble',
                'sim.model', 'sim.grid')


@pytest.mark.parametrize('name', [
    c for c in tracing.COUNTERS if '_launches.' not in c] + list(SURVEY_SPANS))
def test_documented(name):
    # The kernels' replayed and captured launches are named as a group.
    assert f'``{name}``' in tracing.__doc__
