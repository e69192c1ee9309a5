"""PyTorch port, a survey whose tasks solve on automatically built grids.

The survey of tests/test_simulations.py::TestAutoGridding (16^3 cells of
200 m, 1 Ohm m, two x-directed sources, two receivers, 0.5 and 2 Hz) with
``gridding='frequency'``: each frequency gets its grid from
``meshes.construct_mesh``, the model is interpolated to it, and the
gradient comes back through the volume averages' adjoint.  Both packages
run in complex128 on the CPU (JAX in x64, the port with
``device='cpu'``), plain multigrid V-cycles to ``TOL``, with shape
classes off (grids of (24, 16, 16) and (24, 16, 24)) and at 1.7 (both
(24, 16, 24), the first padded).  Each JAX simulation is rebuilt (its
``from_dict``) from what it stored, ``to_dict('computed')`` without the
fields no test reads, beside its results: read from
tests/data/torch_reference.npz, which tests/create_data/torch_reference.py
writes from the JAX package.  ``TOL`` is loose because both packages run
the same cycles (``it_mg`` is held equal), so they agree to rounding
whatever it is, and the port's plain versions take some 0.25 s per cycle
on these grids.

- The port's task loop against the JAX task loop: the grids bit for bit,
  the same ``it_mg`` per task, synthetic data, misfit, gradient and
  ``jvec`` to 1e-8 of the largest entry.
- The port's ``parallel='batch'`` (one batch per grid) against the JAX
  task loop, the same without ``jvec`` (the batch's ``jvec`` is held in
  tests/test_torch_sim_batch.py): with ``EMG3D_TPU_BATCH_SHRINK=1`` a
  lane leaves its batch once converged, so each stops after the cycles
  of its task.
- ``from_emg3d_tpu`` of the computed JAX simulation: the same grids bit
  for bit, data, fields and gradient carried over, and a task solved
  anew from zero on its carried grid gives the same data.
- The port alone, with ``EMG3D_TPU_CYCLE_JIT=1`` (on the CPU a
  whole-cycle step runs its body uncaptured): four frequencies, so four
  grid shapes, with the step cache bounded to two steps.  The task loop
  visits the tasks grid shape by grid shape, so each shape captures its
  step once; after every task the weak caches of states and level stores
  hold only what cached steps use; the results equal the per-operation
  run bit for bit.
"""

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_array_equal

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu_torch import solver as t_solver
from emg3d_tpu_torch.convert import from_emg3d_tpu
from emg3d_tpu_torch.parallel import tasks as t_tasks
from torch_reference import reference

FREQS = (0.5, 2.0)
TOL = 1e-3
CLASSES = [False, 1.7]


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def auto_sim(mod, shape_classes, frequencies=FREQS, tol=TOL, **kwargs):
    """The simulation of tests/test_simulations.py::TestAutoGridding with
    ``gridding='frequency'``, linear receiver interpolation (an exact
    gradient) and plain multigrid V-cycles to ``tol``."""
    return mod.Simulation(**auto_inputs(mod, shape_classes, frequencies,
                                        tol, **kwargs))


def auto_inputs(mod, shape_classes, frequencies=FREQS, tol=TOL, **kwargs):
    """The arguments of ``auto_sim``'s simulation."""
    h = np.ones(16) * 200.0
    grid = mod.TensorMesh([h, h, h], origin=(-1600.,) * 3)
    model = mod.Model(grid, property_x=1.0, mapping='Resistivity')
    sources = [mod.TxElectricDipole((x, 0., -200., 0., 0.))
               for x in (-300., 300.)]
    recs = [mod.RxElectricPoint((x, 0., -250., 0., 0.))
            for x in (600., 900.)]
    survey = mod.Survey(sources, recs, list(frequencies),
                        relative_error=0.05)
    if mod is t3:
        kwargs['device'] = 'cpu'
    return dict(
        survey=survey, model=model, gridding='frequency',
        shape_classes=shape_classes, tqdm_opts=False,
        receiver_interpolation='linear',
        solver_opts={'plain': True, 'cycle': 'V', 'tol': tol, 'verb': 0},
        **kwargs)


def box(shape):
    """The model vector of ``jvec``: 1 in a box around the receivers."""
    v = np.zeros(shape)
    v[9:14, 6:10, 5:9] = 1.0
    return v


def run(sim, jvec=True):
    """Forward data, observed data 1.1 times them, then misfit, gradient
    and (where ``jvec``) ``jvec``; returns them."""
    sim.compute()
    sim.data['observed'] = sim.data.synthetic * 1.1
    out = {'synthetic': np.asarray(sim.data.synthetic).copy(),
           'misfit': sim.misfit, 'gradient': sim.gradient.copy()}
    if jvec:
        out['jvec'] = np.asarray(sim.jvec(box(sim.model.shape))).copy()
    return out


@pytest.fixture(scope='module')
def ref():
    """{shape_classes: (the computed JAX simulation, its results)}: the
    JAX simulation rebuilt from the file."""
    out = {}
    for classes in CLASSES:
        stored = reference(f'gridding.{classes}', auto_inputs(t3, classes))
        out[classes] = (e3.Simulation.from_dict(stored['simulation']),
                        stored['results'])
    return out


def close(a, b, rtol=1e-8):
    """``a`` equals ``b`` to ``rtol`` of the largest entry of ``b``."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(b).max() > 0
    assert np.abs(a - b).max() <= rtol * np.abs(b).max()


def same_grids(out, ref_sim):
    """Every task's grid bit for bit; returns the shapes."""
    shapes = []
    for src in ref_sim.survey.sources:
        for freq in ref_sim.survey.frequencies:
            a, b = out.get_grid(src, freq), ref_sim.get_grid(src, freq)
            assert a.shape_cells == b.shape_cells
            assert_array_equal(a.origin, b.origin)
            for ha, hb in zip(a.h, b.h):
                assert_array_equal(ha, hb)
            shapes.append(a.shape_cells)
    return shapes


def same_results(out, ref_results):
    for key, val in out.items():
        close(val, ref_results[key])


@pytest.mark.parametrize('classes', CLASSES)
def test_task_loop_equals_jax(classes, ref):
    jsim, jres = ref[classes]
    sim = auto_sim(t3, classes)
    res = run(sim)
    shapes = same_grids(sim, jsim)
    assert len(set(shapes)) == (2 if classes is False else 1)
    for src, freq in sim._srcfreq:
        for which in ('efield', 'bfield'):
            info = sim._dict_get(f'{which}_info', src, freq)
            jinfo = jsim._dict_get(f'{which}_info', src, freq)
            assert info['exit'] == 0
            assert info['it_mg'] == jinfo['it_mg'], (which, src, freq)
    same_results(res, jres)
    assert res['gradient'].shape == (16, 16, 16)


@pytest.mark.parametrize('classes', CLASSES)
def test_batch_equals_jax_task_loop(classes, ref, monkeypatch):
    monkeypatch.setenv('EMG3D_TPU_BATCH_SHRINK', '1')
    jsim, jres = ref[classes]
    sim = auto_sim(t3, classes, parallel='batch')
    res = run(sim, jvec=False)
    same_grids(sim, jsim)
    assert len(sim._batch_groups(sim._srcfreq)) == len(FREQS)
    for src, freq in sim._srcfreq:
        assert sim._dict_get('efield_info', src, freq)['exit'] == 0
        assert sim._dict_get('bfield_info', src, freq)['exit'] == 0
    same_results(res, jres)


def test_from_emg3d_tpu(ref):
    jsim, jres = ref[1.7]
    sim = from_emg3d_tpu(jsim, device='cpu')
    assert sim.shape_classes == 1.7 and sim.gridding == 'frequency'
    same_grids(sim, jsim)
    assert_array_equal(np.asarray(sim.data.synthetic), jres['synthetic'])
    assert_array_equal(sim.gradient, jres['gradient'])
    for src, freq in sim._srcfreq:
        assert_array_equal(sim.get_efield(src, freq).field,
                           jsim.get_efield(src, freq).field)

    # A task solved anew on its carried grid.
    sim.clean('computed')
    sim.compute(source='TxED-2', frequency='f-1')
    same_grids(sim, jsim)
    close(sim.data.synthetic.loc['TxED-2', :, 'f-1'],
          jres['synthetic'][1, :, 0])


def step_parts():
    """(states, level stores) that the cached steps hold, by identity."""
    steps = list(t_solver._STEPS.values())
    return ({id(s.state) for s in steps},
            {id(st) for s in steps for st in (s.store, s.store2)
             if st is not None})


def test_step_cache_beyond_its_bound(monkeypatch):
    """Four grid shapes through a cache of two steps (plain V-cycles make
    one step per grid configuration): each shape captures once; after
    every task the weak caches of states and level stores hold exactly
    what the cached steps use (what an evicted step alone held is
    freed); fields, data and cycles equal the per-operation run's."""
    freqs = (0.1, 0.5, 2.0, 8.0)
    monkeypatch.setattr(t_solver, '_MAX_STEPS', 2)
    solve = t_tasks.solve
    held = []

    def task(inp):
        out = solve(inp)
        states, stores = step_parts()
        held.append((len(t_solver._STEPS), states, stores,
                     {id(v) for v in t_solver._STATES.values()},
                     {id(v) for v in t_solver._STORES.values()}))
        return out

    monkeypatch.setattr(t_tasks, 'solve', task)
    sims = {}
    for mode in ('0', '1'):
        monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', mode)
        t_solver._STEPS.clear()
        t_solver.reset_counts()
        held.clear()
        sims[mode] = auto_sim(t3, False, freqs, tol=1e-3)
        shapes = {sims[mode].get_grid(*sf).shape_cells
                  for sf in sims[mode]._srcfreq}
        assert len(shapes) == 4 > t_solver._MAX_STEPS
        sims[mode].compute()
    t_solver._STEPS.clear()     # leave no steps to other tests
    assert not t_solver._STATES and not t_solver._STORES

    assert t_solver.CYCLE_CAPTURES == len(shapes)
    assert t_solver.CYCLE_REPLAYS > 0
    assert len(held) == 8
    for nsteps, states, stores, live_states, live_stores in held:
        assert 0 < nsteps <= 2
        assert live_states == states
        assert live_stores == stores
    sim, ref_sim = sims['1'], sims['0']
    assert_array_equal(np.asarray(sim.data.synthetic),
                       np.asarray(ref_sim.data.synthetic))
    for src, freq in sim._srcfreq:
        assert_array_equal(sim.get_efield(src, freq).field,
                           ref_sim.get_efield(src, freq).field)
        assert (sim.get_efield_info(src, freq)['it_mg']
                == ref_sim.get_efield_info(src, freq)['it_mg'])
