"""PyTorch port, ``Simulation(parallel='batch')``.

The survey of tests/test_torch_sim.py (2 sources x 2 frequencies, two
electric and one magnetic receiver, a VTI model on 8^3 cells of 200 m,
plain multigrid F-cycles to 5e-7, complex128 on the CPU) through the
batched engine, after tests/test_simulations.py:277-390:

- against the JAX package's ``Simulation(parallel='batch')``: synthetic
  data, misfit and gradient to rtol 1e-8 (atol 1e-8 of the largest
  entry), ``jvec`` to rtol 1e-7, the same ``it_mg`` per task, forward and
  adjoint;
- against the port's own ``parallel='task'``: the same to 1e-5 of the
  largest entry (both converge to 5e-7, under different iteration
  control: a batch cycles until every task has converged);
- every task of a batch has the batch's info; a recompute starts from the
  converged fields and does nothing; ``file_dir`` spills each task's
  field and info as the task engine does; a gridding mode with one grid
  per frequency batches per grid; ``from_emg3d_tpu`` carries
  ``parallel='batch'`` across; a single task goes through the batch
  engine too.

The JAX simulation is rebuilt (its ``from_dict``) from what it stored,
``to_dict('all')`` after its gradient, with its ``jvec`` of ``V``: read
from tests/data/torch_reference.npz, which
tests/create_data/torch_reference.py writes from the JAX package (from
the observed data the port computes here).
"""

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_allclose

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu_torch.convert import from_emg3d_tpu
from emg3d_tpu_torch.parallel import batch as tbatch
from torch_reference import reference

N = 8
SRCFREQ = [(s, f) for s in ('TxED-1', 'TxED-2') for f in ('f-1', 'f-2')]


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def make_inputs(mod, parallel, gridding='same', seed=41, observed=True):
    """A small survey and model made by package ``mod`` from a seed, with
    observed data (unless not ``observed``): the responses of the model
    with its resistivities times 1.2, computed by the port's task
    engine."""
    rng = np.random.default_rng(seed)
    h = np.ones(N) * 1600.0 / N
    grid = mod.TensorMesh([h, h, h], origin=(-800.,) * 3)
    shape = grid.shape_cells
    model = mod.Model(grid, property_x=rng.uniform(0.8, 1.2, shape),
                      property_z=rng.uniform(1.5, 2.5, shape),
                      mapping='Resistivity')
    sources = [mod.TxElectricDipole((x, 0., 0., 0., 0.))
               for x in (-100., 100.)]
    receivers = [mod.RxElectricPoint((x, 50., 0., 0., 0.))
                 for x in (250., 350.)]
    receivers += [mod.RxMagneticPoint((300., 0., 100., 90., 0.))]
    survey = mod.Survey(sources, receivers, [1.0, 2.0],
                        relative_error=0.05, noise_floor=1e-17)
    if observed:
        survey.data['observed'] = OBSERVED
    sim_inp = {
        'survey': survey, 'gridding': gridding, 'parallel': parallel,
        'receiver_interpolation': 'linear', 'tqdm_opts': False,
        'solver_opts': {'plain': True, 'tol': 5e-7, 'verb': 0},
    }
    if gridding == 'dict':
        # One grid per frequency, shared by both sources.
        per_freq = {f: mod.TensorMesh([np.ones(N) * w] * 3,
                                      origin=(-N * w / 2,) * 3)
                    for f, w in (('f-1', 200.), ('f-2', 220.))}
        sim_inp['gridding_opts'] = {s: dict(per_freq)
                                    for s in ('TxED-1', 'TxED-2')}
    if mod is t3:
        sim_inp['device'] = 'cpu'
    return model, sim_inp


def _observed():
    rng = np.random.default_rng(41)
    h = np.ones(N) * 1600.0 / N
    grid = t3.TensorMesh([h, h, h], origin=(-800.,) * 3)
    shape = grid.shape_cells
    true = t3.Model(grid, property_x=1.2 * rng.uniform(0.8, 1.2, shape),
                    property_z=1.2 * rng.uniform(1.5, 2.5, shape),
                    mapping='Resistivity')
    survey = t3.Survey(
        [t3.TxElectricDipole((x, 0., 0., 0., 0.)) for x in (-100., 100.)],
        [t3.RxElectricPoint((x, 50., 0., 0., 0.)) for x in (250., 350.)]
        + [t3.RxMagneticPoint((300., 0., 100., 90., 0.))], [1.0, 2.0],
        relative_error=0.05, noise_floor=1e-17)
    sim = t3.Simulation(survey, true, gridding='same', device='cpu',
                        receiver_interpolation='linear', tqdm_opts=False,
                        solver_opts={'plain': True, 'tol': 5e-7, 'verb': 0})
    sim.compute(observed=True, add_noise=False)
    return np.asarray(sim.data.observed).copy()


OBSERVED = _observed()
V = np.random.default_rng(42).normal(size=(2, N, N, N))


def close(a, b, rtol=1e-8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def run(mod, parallel, **kw):
    """A simulation with misfit, gradient and ``jvec`` of V computed."""
    model, sim_inp = make_inputs(mod, parallel, **kw)
    sim = mod.Simulation(model=model, **sim_inp)
    _ = sim.gradient
    sim.jvec_v = np.asarray(sim.jvec(V))
    return sim


def jax_inputs():
    """What the JAX batch simulation of ``sims`` depends on, but for the
    observed data the port computes (the file's answer was made from
    them)."""
    return (*make_inputs(t3, 'batch', observed=False), V)


@pytest.fixture(scope='module')
def sims():
    """{'jax': JAX batch, 'batch': the port's batch, 'task': the port's
    task engine}, each with misfit, gradient and jvec computed; the JAX
    one rebuilt from the file."""
    ref = reference('sim_batch.jax', *jax_inputs())
    jsim = e3.Simulation.from_dict(ref['simulation'])
    jsim.jvec_v = ref['jvec']
    return {'jax': jsim, 'batch': run(t3, 'batch'), 'task': run(t3, 'task')}


@pytest.mark.parametrize('ref,rtol', [('jax', 1e-8), ('task', 1e-5)])
def test_data_misfit_gradient(sims, ref, rtol):
    out, ref = sims['batch'], sims[ref]
    close(out.data.synthetic, ref.data.synthetic, rtol)
    close(out.data.residual, ref.data.residual, rtol)
    assert out.misfit > 0
    assert_allclose(out.misfit, ref.misfit, rtol=rtol)
    assert out.gradient.shape == (2, N, N, N)
    close(out.gradient, ref.gradient, rtol)
    assert np.abs(out.gradient).max() > 0


@pytest.mark.parametrize('ref,rtol', [('jax', 1e-7), ('task', 1e-5)])
def test_jvec(sims, ref, rtol):
    a, b = sims['batch'].jvec_v, sims[ref].jvec_v
    assert np.all(np.isfinite(a)) and np.abs(a).max() > 0
    close(a, b, rtol)


@pytest.mark.parametrize('src,freq', SRCFREQ)
def test_task_info_equals_jax(sims, src, freq):
    out, ref = sims['batch'], sims['jax']
    for which in ('efield', 'bfield'):
        a = out._dict_get(f'{which}_info', src, freq)
        b = ref._dict_get(f'{which}_info', src, freq)
        assert a['it_mg'] == b['it_mg'] > 0
        assert a['it_ssl'] == b['it_ssl'] == 0
        assert a['exit'] == b['exit'] == 0
        assert a['exit_message'] == 'CONVERGED'
        assert_allclose(a['rel_error'], b['rel_error'], rtol=1e-6)
        # Every task of one batch has the batch's cycles.
        assert a['it_mg'] == out._dict_get(f'{which}_info', 'TxED-1',
                                           'f-1')['it_mg']
        close(out._dict_get(which, src, freq).field,
              ref._dict_get(which, src, freq).field)


def test_recompute_does_nothing(sims):
    sim = sims['batch'].copy()
    sim.compute()
    for src, freq in SRCFREQ:
        info = sim.get_efield_info(src, freq)
        assert info['it_mg'] == 0 and info['exit_message'] == 'CONVERGED'
    close(sim.data.synthetic, sims['batch'].data.synthetic, 1e-14)


def test_never_the_task_loop(sims, monkeypatch):
    """A batch simulation solves through the batch engine alone, a single
    task included."""
    from emg3d_tpu_torch.parallel import tasks

    def refuse(*args, **kwargs):
        raise AssertionError('the task loop ran')

    calls = []
    inner = tbatch.solve_batch_fields

    def counted(model, sfields, **kwargs):
        calls.append(len(sfields))
        return inner(model, sfields, **kwargs)

    monkeypatch.setattr(tasks, 'process_map', refuse)
    monkeypatch.setattr(tbatch, 'solve_batch_fields', counted)
    model, sim_inp = make_inputs(t3, 'batch')
    sim = t3.Simulation(model=model, **sim_inp)
    ef = sim.get_efield('TxED-2', 'f-2')
    close(ef.field, sims['batch'].get_efield('TxED-2', 'f-2').field, 1e-5)
    assert calls == [1]


def test_file_dir(sims, tmp_path):
    model, sim_inp = make_inputs(t3, 'batch')
    sim = t3.Simulation(model=model, file_dir=str(tmp_path), **sim_inp)
    sim.compute()
    stored = sim._dict_efield['TxED-1']['f-1']
    assert stored == str(tmp_path / 'efield_TxED-1_f-1_out.h5')
    assert sim._dict_efield_info['TxED-1']['f-1'] == stored
    close(sim.data.synthetic, sims['batch'].data.synthetic, 1e-14)
    info = sim.get_efield_info('TxED-2', 'f-2')
    assert info['exit_message'] == 'CONVERGED' and info['it_mg'] > 0


def test_grid_per_frequency(monkeypatch):
    """One grid per frequency: one batch per grid, equal to the task
    engine."""
    sims = {p: t3.Simulation(model=model, **sim_inp) for p, (model, sim_inp)
            in ((p, make_inputs(t3, p, gridding='dict'))
                for p in ('task', 'batch'))}
    calls = []
    inner = tbatch.solve_batch

    def counted(model, sources, freqs, **kwargs):
        calls.append((model.grid.h[0][0], sorted(freqs)))
        return inner(model, sources, freqs, **kwargs)

    monkeypatch.setattr(tbatch, 'solve_batch', counted)
    for sim in sims.values():
        sim.compute()
    assert sorted(calls) == [(200., [1.0, 1.0]), (220., [2.0, 2.0])]
    close(sims['batch'].data.synthetic, sims['task'].data.synthetic, 1e-5)


def test_from_emg3d_tpu_keeps_batch(sims):
    sim = from_emg3d_tpu(sims['jax'], device='cpu')
    assert sim.parallel == 'batch' and sim.device == 'cpu'
    close(sim.data.synthetic, sims['jax'].data.synthetic, 1e-14)
