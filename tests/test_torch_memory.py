"""PyTorch port, the per-operation paths leave no reference cycle.

A tensor that sits in a reference cycle is freed only when Python's
collector runs its oldest generation; on the card its memory stays
allocated until then (PyTorch's caching allocator does not run the
collector before it reports out of memory).  Each case here runs one
entry point of the port at 16^3 with ``device='cpu'`` while the
collector is off and ``gc.DEBUG_SAVEALL`` keeps everything it finds
unreachable, then collects once: ``gc.garbage`` must hold no
``torch.Tensor`` and no object of a class of ``emg3d_tpu_torch``.

The cases: plain, default and CGS ``solve`` operation by operation
(``EMG3D_TPU_CYCLE_JIT=0``); the default solve through the whole-cycle
steps (``=1``), the step cache emptied inside the case, so that the
steps are released in it too; ``solve_batch`` with a shared eta (plain
multigrid) and with a stacked eta (``epsilon_r``, batched BiCGSTAB);
the grid-sharded solve over ``['cpu'] * 4``, plain and with
semicoarsening and line relaxation; ``Simulation`` compute, gradient and
``jvec`` with ``parallel='task'`` and ``'batch'``; one iteration of
``inversion.native.minimize``; and two exception paths: an error raised
in a smoothing call, out of ``solve``, and a diverging preconditioner,
whose ``_ConvergenceError`` the Krylov solver catches.  The cycles'
results are held bit for bit elsewhere (tests/test_torch_cycle_graph.py,
tests/test_torch_batch*.py, tests/test_torch_domain*.py).
"""

import collections
import gc

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu_torch import solver
from emg3d_tpu_torch.inversion import native
from emg3d_tpu_torch.parallel import batch, domain

N = 16
TOL = 1e-2
SOURCE = (0., 0., 0., 0., 0.)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture
def saveall():
    """The collector off, and every object it finds unreachable kept in
    ``gc.garbage``, while a case runs; its state restored after the
    case, also where the case fails."""
    solver._STEPS.clear()
    gc.collect()
    enabled, flags = gc.isenabled(), gc.get_debug()
    gc.disable()
    gc.set_debug(flags | gc.DEBUG_SAVEALL)
    try:
        yield
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        if enabled:
            gc.enable()
        solver._STEPS.clear()


def leftover():
    """Collect once; the tensors and the port's objects among what was
    unreachable, counted by type."""
    gc.collect()
    found = collections.Counter(
        f"{type(o).__module__}.{type(o).__qualname__}" for o in gc.garbage
        if isinstance(o, torch.Tensor)
        or type(o).__module__.startswith('emg3d_tpu_torch'))
    gc.garbage.clear()
    return found


def model(epsilon_r=False):
    """A triaxial model on 16^3 cells of 50 m, centred on the source."""
    rng = np.random.default_rng(5)
    grid = t3.TensorMesh([np.full(N, 50.0)] * 3, origin=(-N * 25.0,) * 3)
    shape = grid.shape_cells
    kw = {'epsilon_r': rng.uniform(1, 3, shape)} if epsilon_r else {}
    return t3.Model(grid, property_x=rng.uniform(1, 2, shape),
                    property_y=rng.uniform(2, 3, shape),
                    property_z=rng.uniform(3, 5, shape), **kw)


def solve(**kw):
    mod = model()
    sfield = t3.get_source_field(mod.grid, SOURCE, 1.0)
    _, info = t3.solve(mod, sfield, tol=TOL, return_info=True, **kw)
    return info


def per_operation(monkeypatch, **kw):
    monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', '0')
    assert solve(device='cpu', **kw)['exit'] == 0


def steps(monkeypatch):
    monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', '1')
    assert solve(device='cpu')['exit'] == 0
    assert solver._STEPS
    solver._STEPS.clear()


def solve_batch(epsilon_r, **kw):
    _, info = batch.solve_batch(model(epsilon_r), [SOURCE] * 3,
                                [0.5, 1.0, 2.0], device='cpu', tol=TOL,
                                **kw)
    assert info['exit_messages'] == ['CONVERGED'] * 3


def sharded(monkeypatch, **kw):
    monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', '0')
    mesh = domain.make_grid_mesh(devices=['cpu'] * 4)
    assert solve(mesh=mesh, **kw)['exit'] == 0


def simulation(parallel, lgres=None):
    """A one-source, one-frequency survey of two receivers over an
    isotropic model on the 16^3 grid (``lgres``: its log10 resistivity,
    default random), plain multigrid."""
    grid = model().grid
    if lgres is None:
        lgres = np.random.default_rng(3).uniform(0, 0.3, grid.shape_cells)
    mod = t3.Model(grid, lgres, mapping='LgResistivity')
    survey = t3.Survey(
        [t3.TxElectricDipole(SOURCE)],
        [t3.RxElectricPoint((x, 50., 0., 0., 0.)) for x in (150., 250.)],
        [1.0], relative_error=0.05, noise_floor=1e-17)
    survey.data['observed'] = np.full(survey.shape, 1e-12 + 1e-13j)
    return t3.Simulation(
        survey=survey, model=mod, gridding='same', parallel=parallel,
        receiver_interpolation='linear', tqdm_opts=False, device='cpu',
        solver_opts={'plain': True, 'tol': TOL, 'verb': 0})


def survey(parallel):
    sim = simulation(parallel)
    sim.compute()
    assert np.all(np.isfinite(sim.gradient))
    assert np.all(np.isfinite(sim.jvec(np.ones(sim.model.shape))))


def inversion():
    sim = simulation('task', np.zeros((N, N, N)))
    assert native.minimize(sim, maxiter=1, verb=0).n_evaluations > 0


def smoothing_raises(monkeypatch):
    """An error in the sixth smoothing call, out of the default solve."""
    relax, calls = solver._relax, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) > 5:
            raise RuntimeError('smoothing failed')
        return relax(*args, **kwargs)

    monkeypatch.setattr(solver, '_relax', failing)
    try:
        per_operation(monkeypatch)
    except RuntimeError:
        pass
    else:
        raise AssertionError('the solve did not raise')


def preconditioner_diverges(monkeypatch):
    """Every smoothing call blows its field up: the preconditioner
    diverges and the Krylov solver returns a zero field."""
    relax = solver._relax

    def blowing_up(*args, **kwargs):
        return tuple(1e3 * c for c in relax(*args, **kwargs))

    monkeypatch.setattr(solver, '_relax', blowing_up)
    monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', '0')
    info = solve(device='cpu')
    assert info['exit_message'].startswith('DIVERGED')


CASES = {
    'plain': lambda mp: per_operation(mp, plain=True),
    'default': lambda mp: per_operation(mp),
    'cgs': lambda mp: per_operation(mp, sslsolver='cgs'),
    'steps': steps,
    'batch_shared_eta': lambda mp: solve_batch(False),
    'batch_stacked_eta': lambda mp: solve_batch(True, sslsolver=True),
    'sharded_plain': lambda mp: sharded(mp, plain=True),
    'sharded_sc_lr': lambda mp: sharded(mp, sslsolver=False,
                                        semicoarsening=True,
                                        linerelaxation=1),
    'simulation_task': lambda mp: survey('task'),
    'simulation_batch': lambda mp: survey('batch'),
    'inversion': lambda mp: inversion(),
    'smoothing_raises': smoothing_raises,
    'preconditioner_diverges': preconditioner_diverges,
}


@pytest.mark.parametrize('case', list(CASES))
def test_no_cycle_left(case, saveall, monkeypatch):
    CASES[case](monkeypatch)
    assert not leftover()
