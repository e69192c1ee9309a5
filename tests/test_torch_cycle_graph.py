"""PyTorch port, the whole-cycle step (``EMG3D_TPU_CYCLE_JIT``) on the CPU.

On the card a step runs one multigrid cycle, its accumulate and the next
residual norm as one replay of a captured CUDA graph; on the CPU, with
``EMG3D_TPU_CYCLE_JIT=1``, the same step object runs its body uncaptured,
on the same static buffers.  Here, with ``device='cpu'``:

- ``=1`` against ``=0`` for plain F-cycles and for the default solver
  (BiCGSTAB, semicoarsening and line relaxation cycling): fields equal
  bit for bit, the same ``it_ssl``, ``it_mg`` and exit message.  The grid
  is a stretched triaxial 16 x 8 x 8 (16^3 takes 6.5-9 s per solve on the
  CPU);
- a second solve on a new ``Model`` of the same grid makes no new step,
  captures nothing and gives the same field;
- ``verb=4`` runs the per-operation cycle and prints the cycle-QC;
- the level trace of the per-operation cycle (``var.level_all``, which
  the cycle-QC draws) equals the JAX package's, smoothing call by
  smoothing call, for F, W and V cycles at 16^3 with ``nu_init=1`` (the
  JAX package's trace read from tests/data/torch_reference.npz, written
  by tests/create_data/torch_reference.py from the JAX package);
- the step cache stays within its bound;
- ``auto`` is off on the CPU, and the switch is read on every solve.

The case against the JAX package's own solve, ``test_steps_against_jax``,
lies in tests/test_torch_inversion.py.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

from emg3d_tpu import fields, meshes, models
from emg3d_tpu_torch import solver as t_solver
from emg3d_tpu_torch.convert import from_emg3d_tpu
from torch_reference import reference

SHAPE = (16, 8, 8)
OPTIONS = {'plain': dict(plain=True), 'default': {}}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_cache():
    t_solver._STEPS.clear()
    t_solver.reset_counts()
    yield
    t_solver._STEPS.clear()


def problem(shape=SHAPE, seed=3):
    """A stretched triaxial grid centred on an x-dipole, in the JAX
    package's classes (``from_emg3d_tpu`` gives the port's)."""
    rng = np.random.default_rng(seed)
    h = [rng.uniform(40, 80, n) for n in shape]
    grid = meshes.TensorMesh(h, origin=tuple(-0.5 * x.sum() for x in h))
    cells = grid.shape_cells
    model = models.Model(grid, property_x=rng.uniform(1, 3, cells),
                         property_y=2.0,
                         property_z=rng.uniform(2, 5, cells))
    sfield = fields.get_source_field(grid, (0., 0., 0., 0., 0.), 1.0)
    return model, sfield


def port_solve(mode, monkeypatch, shape=SHAPE, **kw):
    """Solve ``problem(shape)`` with the port on the CPU under
    ``EMG3D_TPU_CYCLE_JIT=mode``; a new Model each call."""
    model, sfield = problem(shape)
    monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', mode)
    return t_solver.solve(from_emg3d_tpu(model), from_emg3d_tpu(sfield),
                          device='cpu', return_info=True, **kw)


def same(out, ref):
    (efield, info), (rfield, rinfo) = out, ref
    for key in ('it_ssl', 'it_mg', 'exit_message'):
        assert info[key] == rinfo[key], key
    assert info['exit'] == 0
    assert np.array_equal(efield.field, rfield.field)


@pytest.mark.parametrize('path', list(OPTIONS))
def test_steps_equal_per_operation(path, monkeypatch):
    ref = port_solve('0', monkeypatch, **OPTIONS[path])
    assert t_solver.CYCLE_REPLAYS == 0
    out = port_solve('1', monkeypatch, **OPTIONS[path])
    same(out, ref)
    assert t_solver.CYCLE_CAPTURES == len(t_solver._STEPS) > 0
    assert t_solver.CYCLE_REPLAYS > 0


def test_second_solve_makes_no_step(monkeypatch):
    first = port_solve('1', monkeypatch, (8, 8, 8), plain=True)
    steps = dict(t_solver._STEPS)
    t_solver.reset_counts()
    out = port_solve('1', monkeypatch, (8, 8, 8), plain=True)  # a new Model
    same(out, first)
    assert t_solver._STEPS == steps
    assert t_solver.CYCLE_CAPTURES == 0
    assert t_solver.CYCLE_REPLAYS == out[1]['it_mg']


def test_verb4_runs_per_operation(monkeypatch, capsys):
    _, info = port_solve('1', monkeypatch, (8, 8, 8), plain=True, verb=4)
    assert info['exit'] == 0
    assert t_solver.CYCLE_CAPTURES == t_solver.CYCLE_REPLAYS == 0
    assert not t_solver._STEPS
    out = capsys.readouterr().out
    assert '2h_ \\' in out and '/' in out          # the cycle-QC


def test_cache_bound(monkeypatch):
    monkeypatch.setattr(t_solver, '_MAX_STEPS', 2)
    shapes = [(8, 8, 8), (8, 8, 4), (4, 8, 8)]
    keys = []
    for shape in shapes:
        _, info = port_solve('1', monkeypatch, shape, plain=True)
        assert info['exit'] == 0
        keys.append(next(reversed(t_solver._STEPS)))
        assert len(t_solver._STEPS) <= 2
    assert list(t_solver._STEPS) == keys[1:]      # the oldest dropped
    assert t_solver.CYCLE_CAPTURES == 3


def recording(made, key, cls):
    """``cls`` (an MGParameters), whose instance is kept in
    ``made[key]``."""
    def make(**kwargs):
        made[key] = cls(**kwargs)
        return made[key]
    return make


def trace_options(cycle):
    return dict(plain=True, cycle=cycle, nu_init=1, maxit=4, verb=4)


@pytest.mark.parametrize('cycle', ['F', 'W', 'V'])
def test_level_trace_against_jax(cycle, monkeypatch, capsys):
    """``var.level_all`` of a per-operation 16^3 solve equals the JAX
    package's (``capsys`` takes the verb=4 output, which is not read)."""
    made = {}
    monkeypatch.setattr(t_solver, 'MGParameters',
                        recording(made, 'port', t_solver.MGParameters))
    kw = trace_options(cycle)
    # The JAX package's solve with EMG3D_TPU_CYCLE_JIT=0: its info, the
    # level_all of its MGParameters and their _cycle_qc.
    ref = reference(f'cycle_graph.trace.{cycle}', *problem((16, 16, 16)),
                    kw)
    _, info = port_solve('0', monkeypatch, (16, 16, 16), **kw)
    assert info['it_mg'] == ref['it_mg'] > 1
    trace = made['port'].level_all
    assert len(trace) > 4 * info['it_mg'] and max(trace) == 3
    assert trace == ref['level_all'].tolist()
    assert t_solver._cycle_qc(made['port']) == ref['cycle_qc']


@pytest.mark.parametrize('mode', ['auto', '0'])
def test_off_on_the_cpu(mode, monkeypatch):
    _, info = port_solve(mode, monkeypatch, (8, 8, 8), plain=True)
    assert info['exit'] == 0
    assert t_solver.CYCLE_CAPTURES == t_solver.CYCLE_REPLAYS == 0
    assert not t_solver._STEPS


def test_switch_read_per_solve(monkeypatch):
    ref = port_solve('0', monkeypatch, (8, 8, 8), plain=True)
    assert t_solver.CYCLE_REPLAYS == 0
    out = port_solve('1', monkeypatch, (8, 8, 8), plain=True)
    assert t_solver.CYCLE_CAPTURES == 1
    assert t_solver.CYCLE_REPLAYS == out[1]['it_mg'] - 1
    same(out, ref)
    t_solver.reset_counts()
    port_solve('0', monkeypatch, (8, 8, 8), plain=True)
    assert t_solver.CYCLE_CAPTURES == t_solver.CYCLE_REPLAYS == 0
