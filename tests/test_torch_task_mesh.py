"""PyTorch port, the batch engine's task axis over a device mesh (CPU).

The port's task mesh is a list of ``torch.device`` entries
(``make_task_mesh``); ``['cpu'] * 3`` stands for three devices, driven by
one host loop.  In complex128, on the problem of tests/test_torch_batch.py
with a fourth frequency (4 tasks, padded to 6 lanes over 3 entries):

- ``solve_batch`` over the mesh, plain multigrid and
  ``sslsolver='bicgstab'``: every lane equals the port's unsharded batch
  to 1e-12 with the same iterations, and the JAX package's
  ``solve_batch(mesh=None)`` to 1e-10 (its answer read from
  tests/data/torch_reference.npz, written by
  tests/create_data/torch_reference.py from the JAX package); with
  active shrink (``EMG3D_TPU_BATCH_SHRINK=1``) too, where the recompacted
  lanes move between entries;
- ``_shrink_size`` against the JAX rule for a table of
  ``(ntask, n_active, nd)``;
- ``Simulation(parallel='batch')`` with its device helper patched to two
  CPU entries equals the one-device batch (data, misfit, gradient);
- ``dryrun_multichip(4, devices=['cpu'] * 4)``.
"""

import functools

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu.parallel import batch as jbatch
from emg3d_tpu_torch.parallel import batch as tbatch
from emg3d_tpu_torch.parallel import dryrun_multichip
from torch_reference import Field, reference

N = 8
FREQS = [0.5, 1.0, 2.0, 4.0]
SOURCE = (0., 0., 0., 20., 10.)
CASES = {
    'plain': dict(cycle='F', tol=1e-8, maxit=30),
    'bicgstab': dict(sslsolver='bicgstab', tol=1e-8),
}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def problem(mod, zero=()):
    """(model, source fields) by package ``mod`` from a seed; the tasks
    in ``zero`` get a zero source."""
    rng = np.random.default_rng(8)
    h = np.ones(N) * 200.0
    grid = mod.TensorMesh([h, h, h], origin=(-800.,) * 3)
    shape = grid.shape_cells
    model = mod.Model(grid, property_x=rng.uniform(1, 2, shape),
                      property_y=rng.uniform(2, 3, shape),
                      property_z=rng.uniform(3, 5, shape),
                      mapping='Resistivity')
    sfields = [mod.get_source_field(grid, SOURCE, f) for f in FREQS]
    for i in zero:
        sfields[i].field *= 0.0
    return model, sfields


def batch_inputs(case):
    """What the JAX package's batched solve of ``case`` depends on."""
    return problem(t3)[0], SOURCE, FREQS, CASES[case]


def jax_solve(case):
    """The JAX package's ``solve_batch_fields(mesh=None)`` of ``case``,
    read from tests/data/torch_reference.npz: (lanes, info)."""
    ref = reference(f'task_mesh.{case}', *batch_inputs(case))
    return [Field(f) for f in ref['fields']], ref


@functools.lru_cache(maxsize=None)
def port_solve(case, entries, zero=()):
    """The port's batch of ``case``; ``entries`` CPU entries of a task
    mesh, or 0 for no mesh."""
    mesh = (tbatch.make_task_mesh(devices=['cpu'] * entries) if entries
            else None)
    kw = dict(mesh=mesh) if mesh else dict(device='cpu')
    return t3.solve_batch_fields(*problem(t3, zero), **kw, **CASES[case])


def assert_lanes(out, ref, tol):
    (out_f, info), (ref_f, info_ref) = out, ref
    assert (info['it_mg'], info['it_ssl']) == (info_ref['it_mg'],
                                               info_ref['it_ssl'])
    assert list(info['exit_messages']) == list(info_ref['exit_messages'])
    assert len(out_f) == len(ref_f) == len(FREQS)
    for a, b in zip(out_f, ref_f):
        assert (np.linalg.norm(a.field - b.field)
                <= tol * np.linalg.norm(b.field))


def test_make_task_mesh():
    mesh = tbatch.make_task_mesh(devices=['cpu'] * 3)
    assert mesh.devices.shape == (3,) and mesh.axis_names == ('task',)
    assert tbatch.make_task_mesh(2, devices=['cpu'] * 3).shape == (2,)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.make_task_mesh()              # no card here
    model, sfields = problem(t3)
    with pytest.raises(ValueError, match='1-D over'):
        t3.solve_batch_fields(model, sfields, mesh=mesh, axis='other')


@pytest.mark.parametrize('case', list(CASES))
def test_task_mesh_equals_unsharded_and_jax(case):
    out = port_solve(case, 3)
    assert out[1]['exit_messages'] == ['CONVERGED'] * len(FREQS)
    assert len(out[1]['abs_error']) == len(FREQS)
    assert_lanes(out, port_solve(case, 0), 1e-12)
    assert_lanes(out, jax_solve(case), 1e-10)


@pytest.mark.parametrize('entries', [2, 3])
def test_task_mesh_shrink(entries, monkeypatch, capsys):
    """Active shrink over the mesh: lanes 1 to 3 (and the padding) are
    born converged, the batch shrinks to the mesh size (the unsharded one
    to 1 lane), lanes move between entries; the fields equal the
    unsharded batch's.  (With two active lanes that converge in
    different cycles the unsharded batch would drop the first one a
    cycle before the mesh can, as in the JAX package.)"""
    monkeypatch.setenv('EMG3D_TPU_BATCH_SHRINK', '1')
    mesh = tbatch.make_task_mesh(devices=['cpu'] * entries)
    kw = dict(CASES['plain'], verb=4)
    zero = (1, 2, 3)
    out = t3.solve_batch_fields(*problem(t3, zero), mesh=mesh, **kw)
    assert f'batch shrunk to {entries}/' in capsys.readouterr().out
    ref = t3.solve_batch_fields(*problem(t3, zero), device='cpu', **kw)
    assert 'batch shrunk to 1/' in capsys.readouterr().out
    assert_lanes(out, ref, 1e-12)
    assert not any(np.any(out[0][i].field) for i in zero)


@pytest.mark.parametrize('ntask,n_active,nd', [
    (8, 1, 1), (8, 1, 2), (8, 3, 2), (8, 1, 4), (6, 1, 3), (6, 2, 3),
    (12, 2, 3), (16, 5, 2), (4, 0, 4), (16, 1, 8), (9, 4, 3)])
def test_shrink_size_equals_jax(ntask, n_active, nd):
    assert (tbatch._shrink_size(ntask, n_active, nd)
            == jbatch._shrink_size(ntask, n_active, nd))


def test_simulation_batch_over_two_entries(monkeypatch):
    """``_batch_setup`` spreads the batch over every device its helper
    returns (two CPU entries here): data, misfit and gradient (forward
    and adjoint batches) equal one device's."""
    from test_torch_sim_batch import make_inputs

    def compute():
        model, sim_inp = make_inputs(t3, 'batch')
        sim = t3.Simulation(model=model, **sim_inp)
        return sim, np.asarray(sim.gradient)

    one = compute()
    assert 'mesh' not in one[0]._batch_setup(1e-6)
    monkeypatch.setattr(t3.simulations, '_batch_devices',
                        lambda device: [torch.device('cpu')] * 2)
    two = compute()
    assert two[0]._batch_setup(1e-6)['mesh'].shape == (2,)
    for a, b in zip((two[0].data.synthetic, two[0].misfit, *two[1:]),
                    (one[0].data.synthetic, one[0].misfit, *one[1:])):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


def test_dryrun_multichip_on_four_cpu_entries():
    out = dryrun_multichip(4, devices=['cpu'] * 4)
    assert out['mesh'] == (2, 2)
    assert out['batch_rel'] < 1e-10 and out['grid_rel'] < 1e-10
