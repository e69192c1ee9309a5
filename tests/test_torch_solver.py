"""PyTorch port, plain multigrid solve against ``emg3d_tpu.solver.solve``.

Both packages solve the same problem in complex128 on the CPU (JAX in x64
mode): a stretched, non-cubic, anisotropic grid whose axes stop
coarsening at different depths (16 x 8 x 12 -> 8 x 4 x 6 -> 4 x 2 x 3 ->
2 x 2 x 3), so partial coarsening is exercised.  Same cycle count and
exit message, rel_error to rtol 1e-8, fields to rtol 1e-10.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from emg3d_tpu import fields, meshes, models, solver
from emg3d_tpu_torch import convert
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
    jkw, tkw = dict(kw), dict(kw)
    if efield is not None:
        jkw['efield'] = efield.copy()
        tkw['efield'] = convert.from_emg3d_tpu(efield.copy())
    ref = solver.solve(model, sfield, **jkw)
    out = t_solver.solve(convert.from_emg3d_tpu(model),
                         convert.from_emg3d_tpu(sfield), **tkw)
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
    {},                                             # the defaults
    {'sslsolver': True, 'semicoarsening': False, 'linerelaxation': False},
    {'plain': True, 'semicoarsening': 123},
    {'plain': True, 'linerelaxation': 4},
])
def test_unported_options_raise(problem, kw):
    model, sfield = problem
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        t_solver.solve(convert.from_emg3d_tpu(model),
                       convert.from_emg3d_tpu(sfield), **kw)


def test_cuda_without_card_raises(problem, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model, sfield = problem
    with pytest.raises(RuntimeError, match='cuda'):
        t_solver.solve(convert.from_emg3d_tpu(model),
                       convert.from_emg3d_tpu(sfield), plain=True,
                       device='cuda')
