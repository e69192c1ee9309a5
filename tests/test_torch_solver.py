"""PyTorch port, solves against ``emg3d_tpu.solver.solve`` and oracles.

Both packages solve the same problem in complex128 on the CPU (JAX in x64
mode, the port with ``device='cpu'``): a stretched, non-cubic,
anisotropic grid whose axes stop coarsening at different depths (16 x 8 x
12 -> 8 x 4 x 6 -> 4 x 2 x 3 -> 2 x 2 x 3), so partial coarsening is
exercised.  Same cycle count and exit message, rel_error to rtol 1e-8,
fields to rtol 1e-10.  The default solver (BiCGSTAB, semicoarsening,
line relaxation) is held against the dense direct solve of
tests/alternatives.py; invalid options raise the JAX package's messages,
and no device on a host without a card raises.  The north-star problems
of ``emg3d_tpu_torch.northstar`` equal those of ``bench.py`` and
``tools/bench_northstar.py``.
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import alternatives
from emg3d_tpu import fields, meshes, models, solver
from emg3d_tpu_torch import northstar
from emg3d_tpu_torch.convert import from_emg3d_tpu
from emg3d_tpu_torch import models as t_models
from emg3d_tpu_torch import solver as t_solver


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def problem():
    rng = np.random.default_rng(1)
    h = [rng.uniform(50, 150, n) for n in (16, 8, 12)]
    grid = meshes.TensorMesh(h, origin=(-800., -400., -600.))
    shape = grid.shape_cells
    model = models.Model(grid, property_x=rng.uniform(1, 3, shape),
                         property_z=rng.uniform(2, 5, shape),
                         mapping='Resistivity')
    sfield = fields.get_source_field(grid, (10., 0., 0., 0., 0.), 0.77)
    return model, sfield


def _both(model, sfield, efield=None, **kw):
    """Solve with both packages; returns ((field, info), (field, info))."""
    kw = dict(plain=True, return_info=True, **kw)
    jkw, tkw = dict(kw), dict(kw, device='cpu')
    if efield is not None:
        jkw['efield'] = efield.copy()
        tkw['efield'] = from_emg3d_tpu(efield.copy())
    ref = solver.solve(model, sfield, **jkw)
    out = t_solver.solve(from_emg3d_tpu(model),
                         from_emg3d_tpu(sfield), **tkw)
    return out, ref


def _same(out, ref):
    (efield, info), (jfield, jinfo) = out, ref
    assert info['it_mg'] == jinfo['it_mg']
    assert info['exit'] == jinfo['exit']
    assert info['exit_message'] == jinfo['exit_message']
    assert_allclose(info['rel_error'], jinfo['rel_error'], rtol=1e-8)
    assert_allclose(efield.field, jfield.field, rtol=1e-10,
                    atol=1e-10 * np.abs(jfield.field).max())


@pytest.mark.parametrize('cycle', ['F', 'V', 'W'])
def test_plain_cycles(problem, cycle):
    out, ref = _both(*problem, cycle=cycle, tol=1e-6)
    _same(out, ref)
    assert out[1]['exit'] == 0
    assert out[1]['it_mg'] > 2


def test_warm_start_and_pec(problem):
    model, sfield = problem
    rng = np.random.default_rng(2)
    n = sfield.field.size
    start = fields.Field(sfield.grid, data=1e-9 * (
        rng.normal(size=n) + 1j * rng.normal(size=n)), frequency=0.77)
    # Nonzero boundary edges: both solvers must zero them (PEC).
    out, ref = _both(model, sfield, efield=start, cycle='F', tol=1e-6,
                     always_return=True)
    _same(out, ref)
    assert not out[0].fx[:, 0, :].any()

    # A field that is already good enough: NOTHING DONE, zero cycles.
    out2, ref2 = _both(model, sfield, efield=ref[0], cycle='F', tol=1e-3,
                       always_return=True)
    _same(out2, ref2)
    assert out2[1]['it_mg'] == 0
    assert out2[1]['exit_message'] == 'CONVERGED'


def test_zero_source(problem):
    model, sfield = problem
    zero = fields.Field(sfield.grid, frequency=0.77)
    out, ref = _both(model, zero)
    assert out[1]['it_mg'] == ref[1]['it_mg'] == 0
    assert out[1]['exit'] == ref[1]['exit'] == 0
    assert np.isnan(out[1]['rel_error'])
    assert not out[0].field.any()


@pytest.mark.parametrize('kw', [
    {'semicoarsening': 4},
    {'linerelaxation': 18},
    {'sslsolver': 'gmres'},
    {'sslsolver': False, 'cycle': None},
    {'cycle': 'X'},
])
def test_invalid_options_raise(problem, kw):
    model, sfield = problem
    with pytest.raises(ValueError) as ref:
        solver.solve(model, sfield, **kw)
    with pytest.raises(ValueError) as out:
        t_solver.solve(from_emg3d_tpu(model),
                       from_emg3d_tpu(sfield), device='cpu', **kw)
    assert str(out.value) == str(ref.value)


def test_default_solve_triaxial_dense():
    """The default solver (MG-preconditioned BiCGSTAB, semicoarsening
    cycling 1-2-3, line relaxation cycling 4-5-6) on the 8^3 triaxial
    fullspace of tests/test_solver.py::test_bicgstab_triaxial, against
    the dense direct solve."""
    grid = meshes.TensorMesh([np.ones(8) * 50.0] * 3, origin=[-200.0] * 3)
    model = models.Model(grid, property_x=1.0, property_y=2.0,
                         property_z=3.0)
    sfield = fields.get_source_field(grid, (0, 0, 0, 0, 0), 1.0)
    tmodel = from_emg3d_tpu(model)
    tsfield = from_emg3d_tpu(sfield)
    efield, info = t_solver.solve(tmodel, tsfield, tol=1e-8,
                                  return_info=True, device='cpu')
    assert info['exit_message'] == 'CONVERGED'
    assert info['it_ssl'] > 0 and info['it_mg'] > 0

    vmodel = t_models.VolumeModel(tmodel, tsfield)
    A = alternatives.dense_matrix(grid, vmodel)
    mask = alternatives.interior_mask(grid)
    b = alternatives.field_to_cvec(sfield)
    e = alternatives.field_to_cvec(efield)
    x = np.zeros_like(b)
    x[mask] = np.linalg.solve(A[np.ix_(mask, mask)], b[mask])
    err = np.linalg.norm(e[mask] - x[mask]) / np.linalg.norm(x[mask])
    assert err < 1e-5


def test_cuda_without_card_raises(problem, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model, sfield = problem
    with pytest.raises(RuntimeError, match='cuda'):
        t_solver.solve(from_emg3d_tpu(model),
                       from_emg3d_tpu(sfield), plain=True,
                       device='cuda')


def test_no_device_without_card_raises(problem, monkeypatch):
    """No device means the card: without one, solve raises and runs
    nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)

    def ran(*args, **kwargs):
        raise AssertionError('the solve ran')

    monkeypatch.setattr(t_solver, 'krylov', ran)
    monkeypatch.setattr(t_solver, 'multigrid', ran)
    model, sfield = problem
    for kw in ({}, {'plain': True}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_solver.solve(from_emg3d_tpu(model),
                           from_emg3d_tpu(sfield), **kw)


def _load_script(path, monkeypatch):
    """Import a script by path; the environment it sets is undone after
    the test."""
    for key in ('JAX_PLATFORMS', 'JAX_ENABLE_X64'):
        monkeypatch.setenv(key, os.environ.get(key, ''))
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('case', ['baseline', 'triaxial', 'marine'])
def test_northstar_problems(case, monkeypatch):
    root = pathlib.Path(__file__).resolve().parent.parent
    if case == 'baseline':
        model, sfield = _load_script(root / 'bench.py',
                                     monkeypatch).make_problem(16)
    else:
        script = _load_script(root / 'tools' / 'bench_northstar.py',
                              monkeypatch)
        _, model, sfield = getattr(script, f'{case}_problem')(16)
    tmodel, tsfield = getattr(northstar, f'{case}_problem')(16)
    assert tmodel.shape == model.shape
    for i in range(3):
        assert_allclose(tmodel.grid.h[i], model.grid.h[i], rtol=1e-15)
    assert_allclose(tmodel.grid.origin, model.grid.origin, rtol=1e-15)
    for name in ('property_x', 'property_y', 'property_z'):
        a, b = getattr(tmodel, name), getattr(model, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert_allclose(a, b, rtol=1e-15)
    assert tsfield.frequency == sfield.frequency
    assert_allclose(tsfield.field, sfield.field, rtol=1e-12,
                    atol=1e-12 * np.abs(sfield.field).max())
