"""PyTorch port, solver pieces of the default path against the JAX package.

On the CPU in complex128/float64 (JAX in x64): the effective
semicoarsening and line-relaxation directions, the per-``sc_dir``
hierarchies (shapes, ``c_lr_dir``, ``coarsen`` and every array to
1e-15), ``MGParameters`` (cycling, depth table, messages), and the
native Krylov solvers (BiCGSTAB, CGS, GCROT(m,k)) on an 8^3 operator
without preconditioner: the same ``info``, iterate to rtol 1e-10.  The
Field-level wrappers ``residual``, ``restriction``, ``prolongation`` and
``RegularGridProlongator`` and ``smoothing`` agree with the JAX
package's to 1e-12.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from emg3d_tpu import fields, meshes, models, solver
from emg3d_tpu.ops import operator
from emg3d_tpu_torch.convert import from_emg3d_tpu
from emg3d_tpu_torch import models as t_models
from emg3d_tpu_torch import solver as t_solver
from emg3d_tpu_torch.ops import operator as t_operator

SHAPES = list(itertools.product((2, 3, 4), repeat=3))


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(shape, seed=5, frequency=0.9):
    """A stretched triaxial problem in both packages: (JAX vmodel, port
    vmodel, JAX sfield)."""
    rng = np.random.default_rng(seed)
    h = [rng.uniform(40, 90, n) for n in shape]
    grid = meshes.TensorMesh(h, origin=[-0.5 * x.sum() for x in h])
    model = models.Model(grid, property_x=rng.uniform(1, 3, shape),
                         property_y=rng.uniform(1, 4, shape),
                         property_z=rng.uniform(2, 6, shape),
                         mapping='Resistivity')
    sfield = fields.get_source_field(grid, (5., -3., 2., 20., 10.),
                                     frequency)
    vm = models.VolumeModel(model, sfield)
    tvm = t_models.VolumeModel(from_emg3d_tpu(model),
                               from_emg3d_tpu(sfield))
    return vm, tvm, sfield


@pytest.mark.parametrize('sc_dir', range(4))
def test_current_sc_dir(sc_dir):
    for shape in SHAPES:
        assert (t_solver._current_sc_dir(sc_dir, shape)
                == solver._current_sc_dir(sc_dir, shape))


@pytest.mark.parametrize('lr_dir', range(8))
def test_current_lr_dir(lr_dir):
    for shape in SHAPES:
        assert (t_solver._current_lr_dir(lr_dir, shape)
                == solver._current_lr_dir(lr_dir, shape))


def test_coarsen_flags():
    for c in range(7):
        assert t_solver._coarsen_flags(c) == solver._coarsen_flags(c)


def _params(mod, **kw):
    base = dict(verb=0, sslsolver=True, semicoarsening=True,
                linerelaxation=True, shape_cells=(16, 8, 6))
    base.update(kw)
    if mod is t_solver:
        base['device'] = 'cpu'
    return mod.MGParameters(**base)


@pytest.mark.parametrize('sc_dir', range(4))
def test_build_hierarchy(monkeypatch, sc_dir):
    # The strided JAX smoother: no pre-blocked operands in the hierarchy.
    monkeypatch.setenv('EMG3D_TPU_SMOOTHER', 'xla')
    vm, tvm, _ = _problem((16, 8, 6))
    var = _params(solver)
    ref_meta, ref = solver._build_hierarchy(vm, sc_dir, 4,
                                            var.clevel[sc_dir])
    meta, levels = t_solver._build_hierarchy(
        tvm, sc_dir, 4, var.clevel[sc_dir], torch.device('cpu'),
        (torch.complex128, torch.float64))
    assert meta == ref_meta
    assert len(levels) == len(ref) == len(meta) > 1
    names = ('eta_x', 'eta_y', 'eta_z', 'zeta', 'hx', 'hy', 'hz')

    def close(a, b):
        assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)

    for lvl, arrs in zip(levels, ref):
        for name, t in zip(names, lvl.ops):
            close(t, arrs[name])
        for got, want in zip(lvl.rw or (), arrs.get('rw', ())):
            assert (got is None) == (want is None)
            for a, b in zip(got or (), want or ()):
                close(a, b)
        for got, want in zip(lvl.pm or (), arrs.get('pm', ())):
            assert (got is None) == (want is None)
            if got is not None:
                assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
                close(got[1], want[1])
    # The level-0 operator of the convergence residual is the model.
    for name, t in zip(names, levels[0].ops64):
        close(t, ref[0][name])


def test_hierarchies_share_arrays_across_lr_dir():
    _, tvm, _ = _problem((16, 8, 6))
    var = _params(t_solver)
    hier = t_solver._Hierarchies(tvm, var)
    meta4, lv4 = hier.get(1, 4)
    meta6, lv6 = hier.get(1, 6)
    assert lv4 is lv6
    assert [m[0] for m in meta4] == [m[0] for m in meta6]
    assert ([m[1] for m in meta4]
            == [solver._current_lr_dir(4, m[0]) for m in meta4])
    assert hier.get(2, 4)[1] is not lv4


@pytest.mark.parametrize('kw', [
    {},
    {'semicoarsening': 2, 'linerelaxation': 7},
    {'semicoarsening': 1213, 'linerelaxation': 45, 'sslsolver': 'gcrotmk',
     'cycle': 'W', 'maxit': 20},
    {'semicoarsening': False, 'linerelaxation': False, 'sslsolver': False,
     'cycle': 'V', 'clevel': 1},
    {'sslsolver': 'cgs', 'cycle': None},
])
def test_mgparameters_cycling(kw):
    ref, out = _params(solver, **kw), _params(t_solver, **kw)
    for name in ('sslsolver', 'semicoarsening', 'linerelaxation', 'cycle',
                 'cycmax', 'maxit', 'ssl_maxit', 'maxcycle', 'sc_dir',
                 'lr_dir'):
        assert getattr(out, name) == getattr(ref, name), name
    assert list(out.clevel) == list(ref.clevel)
    for name in ('sc_cycle', 'lr_cycle'):
        a, b = getattr(out, name), getattr(ref, name)
        assert bool(a) == bool(b)
        if a:
            assert ([int(next(a)) for _ in range(7)]
                    == [int(next(b)) for _ in range(7)])
    # repr: the JAX package's lines, then the device.
    assert repr(out) == repr(ref) + "   Device         : cpu\n"


@pytest.mark.parametrize('kw', [
    {'semicoarsening': 4},
    {'semicoarsening': 124},
    {'linerelaxation': 8},
    {'linerelaxation': 148},
    {'sslsolver': 'minres'},
    {'cycle': 'X'},
    {'sslsolver': False, 'cycle': None},
    {'shape_cells': (16, 1, 6)},
])
def test_mgparameters_messages(kw):
    with pytest.raises(ValueError) as ref:
        _params(solver, **kw)
    with pytest.raises(ValueError) as out:
        _params(t_solver, **kw)
    assert str(out.value) == str(ref.value)


class _Var:
    """The slice of MGParameters the Krylov solvers read and write."""

    def __init__(self, tol, maxit):
        self.tol, self.ssl_maxit, self.l2 = tol, maxit, 1.0
        self.history = []

    def callback(self):
        self.history.append(self.l2)


@pytest.fixture(scope='module')
def krylov_problem():
    vm, tvm, sfield = _problem((8, 8, 8), seed=7, frequency=2e3)
    jops = [jnp.asarray(getattr(vm, k)) for k in
            ('eta_x', 'eta_y', 'eta_z', 'zeta')]
    jops += [jnp.asarray(h) for h in vm.grid.h]
    tops = t_solver._level_tensors(
        tvm.eta_x, tvm.eta_y, tvm.eta_z, tvm.zeta, tvm.grid.h,
        torch.device('cpu'), (torch.complex128, torch.float64))
    b = [np.ascontiguousarray(f) for f in (sfield.fx, sfield.fy, sfield.fz)]
    x0 = [np.zeros_like(c) for c in b]
    jmat = jax.jit(lambda e: operator.amat_x(*e, *jops))
    return jmat, tops, b, x0


@pytest.mark.parametrize('name,tol,maxit,kw', [
    ('bicgstab', 1e-6, 60, {}), ('cgs', 1e-6, 60, {}),
    ('gcrotmk', 1e-6, 30, {'m': 3, 'k': 2}), ('bicgstab', 1e-14, 6, {})])
def test_krylov_equals_jax(krylov_problem, name, tol, maxit, kw):
    jmat, tops, b, x0 = krylov_problem
    fn = '_' + name
    jvar, tvar = _Var(tol, maxit), _Var(tol, maxit)
    jx, jinfo = getattr(solver, fn)(
        jmat, None, tuple(jnp.asarray(c) for c in b),
        tuple(jnp.asarray(c) for c in x0), jvar, jvar.callback, **kw)
    tx, tinfo = getattr(t_solver, fn)(
        lambda e: t_operator.amat_x(*e, *tops), None,
        tuple(torch.from_numpy(c) for c in b),
        tuple(torch.from_numpy(c) for c in x0), tvar, tvar.callback, **kw)
    assert tinfo == jinfo
    assert len(tvar.history) == len(jvar.history) > 0
    assert_allclose(tvar.history, jvar.history, rtol=1e-10)
    for a, c in zip(tx, jx):
        c = np.asarray(c)
        assert_allclose(a.numpy(), c, rtol=1e-10, atol=1e-10 * np.abs(c).max())


@pytest.fixture(scope='module')
def wrapper_problem():
    vm, tvm, sfield = _problem((8, 6, 4), seed=9)
    rng = np.random.default_rng(10)
    n = sfield.field.size
    data = 1e-3 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    efield = fields.Field(sfield.grid, data=data, frequency=0.9)
    return vm, tvm, sfield, efield


def _t(obj):
    return from_emg3d_tpu(obj)


@pytest.mark.parametrize('lr_dir', [0, 4])
def test_smoothing_wrapper(wrapper_problem, lr_dir):
    """The Field-level wrapper against the JAX package's: the point
    smoother at lr_dir 0, y- then z-lines at lr_dir 4, nu=1."""
    vm, tvm, sfield, efield = wrapper_problem
    ref = efield.copy()
    solver.smoothing(vm, sfield, ref, 1, lr_dir)
    out = _t(efield.copy())
    t_solver.smoothing(tvm, _t(sfield), out, 1, lr_dir, device='cpu')
    assert_allclose(out.field, ref.field, rtol=1e-12,
                    atol=1e-12 * np.abs(ref.field).max())
    assert not np.allclose(out.field, efield.field)


def test_residual_restriction_prolongation_wrappers(wrapper_problem):
    vm, tvm, sfield, efield = wrapper_problem
    res = solver.residual(vm, sfield, efield)
    tres = t_solver.residual(tvm, _t(sfield), _t(efield), device='cpu')
    assert_allclose(tres.field, res.field, rtol=1e-12,
                    atol=1e-12 * np.abs(res.field).max())
    assert_allclose(
        t_solver.residual(tvm, _t(sfield), _t(efield), True, device='cpu'),
        solver.residual(vm, sfield, efield, True), rtol=1e-12)

    for sc_dir in range(4):
        cm, cs, ce = solver.restriction(vm, sfield, res, sc_dir)
        tcm, tcs, tce = t_solver.restriction(tvm, _t(sfield), tres, sc_dir,
                                             device='cpu')
        assert tcs.grid.shape_cells == cs.grid.shape_cells
        assert_allclose(tcs.field, cs.field, rtol=1e-12,
                        atol=1e-12 * np.abs(cs.field).max())
        for name in ('eta_x', 'eta_y', 'eta_z', 'zeta'):
            assert_allclose(getattr(tcm, name), getattr(cm, name),
                            rtol=1e-14)
        assert not tce.field.any() and tce.field.shape == ce.field.shape

        # Prolong the restricted residual back, onto the fine field.
        fine, tfine = efield.copy(), _t(efield.copy())
        solver.prolongation(fine, cs, sc_dir)
        t_solver.prolongation(tfine, tcs, sc_dir, device='cpu')
        assert_allclose(tfine.field, fine.field, rtol=1e-12,
                        atol=1e-12 * np.abs(fine.field).max())


def test_regular_grid_prolongator():
    rng = np.random.default_rng(11)
    cx, cy = np.cumsum(rng.uniform(1, 2, 5)), np.cumsum(rng.uniform(1, 2, 4))
    x = np.linspace(cx[0], cx[-1], 9)
    y = np.linspace(cy[0], cy[-1], 7)
    values = rng.normal(size=(5, 4))
    assert_allclose(t_solver.RegularGridProlongator(cx, cy, x, y)(values),
                    solver.RegularGridProlongator(cx, cy, x, y)(values),
                    rtol=1e-14)
