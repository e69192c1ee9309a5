"""PyTorch port, the batch engine against ``emg3d_tpu.parallel.batch``.

The port solves in complex128 on the CPU (``device='cpu'``): a random
triaxial model on 8^3 cells of 200 m, an inclined dipole at the centre,
three frequencies (0.5, 1 and 2 Hz: eta scales other than 1).  The
answers of ``emg3d_tpu.parallel.batch.solve_batch_fields`` (JAX in x64 on
the CPU, on the same inputs) are read from tests/data/torch_reference.npz,
which tests/create_data/torch_reference.py writes from the JAX package;
tests/test_torch_batch_krylov.py and tests/test_torch_batch_layouts.py
import the problem from here.

- ``solve_batch_fields`` lane by lane, the port against the JAX package,
  for plain multigrid with a shared eta and an already-converged warm
  start (0 iterations): fields to 1e-10 (norm-wise), the same ``it_mg``,
  ``it_ssl`` and exit messages, relative errors to 1e-6 (they are ~1e-9
  themselves).
- Every lane against the port's own sequential ``solve``: plain
  multigrid over the batch's cycles (every lane cycles until all have
  converged) to 1e-12; the production configuration (BiCGSTAB,
  semicoarsening and line relaxation cycling) to 1e-6 (the batch runs a
  fixed number of preconditioner cycles where ``solve`` may stop early,
  as in the JAX package).
- The Krylov guards of tests/test_batch_engine.py (``_guarded_div``, a
  non-finite beta, a frozen converged lane, ``_shrink_size`` and
  ``_keep_lanes``) against the JAX functions on the same numpy inputs.
- Operator, residual norm and transfers on a leading task axis equal a
  loop over the lanes; the plain smoother twins with a task axis equal
  today's twins lane by lane, bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_allclose

import emg3d_tpu_torch as t3
from emg3d_tpu.parallel import batch as jbatch
from emg3d_tpu_torch import models, solver
from emg3d_tpu_torch.ops import operator, smoothers, transfer
from emg3d_tpu_torch.parallel import batch as tbatch
from torch_reference import Field, reference

N = 8
FREQS = [0.5, 1.0, 2.0]
SOURCE = (0., 0., 0., 20., 10.)
CASES = {
    'plain': dict(cycle='F', tol=1e-8, maxit=30),
    'production': dict(sslsolver=True, semicoarsening=True,
                       linerelaxation=True, tol=1e-8),
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


def problem(mod, epsilon_r=False, zero=()):
    """(model, source fields) by package ``mod`` from a seed; the tasks
    in ``zero`` get a zero source."""
    rng = np.random.default_rng(8)
    h = np.ones(N) * 200.0
    grid = mod.TensorMesh([h, h, h], origin=(-800.,) * 3)
    shape = grid.shape_cells
    kw = {'epsilon_r': rng.uniform(1.0, 3.0, shape)} if epsilon_r else {}
    model = mod.Model(grid, property_x=rng.uniform(1, 2, shape),
                      property_y=rng.uniform(2, 3, shape),
                      property_z=rng.uniform(3, 5, shape),
                      mapping='Resistivity', **kw)
    sfields = [mod.get_source_field(grid, SOURCE, f) for f in FREQS]
    for i in zero:
        sfields[i].field *= 0.0
    return model, sfields


def batch_inputs(kw, epsilon_r=False, warm=False, zero=()):
    """What a JAX batched solve of ``problem`` with solver options ``kw``
    depends on (``warm``: started from its own converged fields)."""
    return problem(t3, epsilon_r)[0], SOURCE, FREQS, kw, warm, zero


def jax_solve(name, kw, epsilon_r=False, warm=False, zero=()):
    """The JAX package's batched solve (``emg3d_tpu.parallel.batch
    .solve_batch_fields``), read from tests/data/torch_reference.npz as
    case ``name``: (lanes with a ``field``, info)."""
    ref = reference(name, *batch_inputs(kw, epsilon_r, warm, zero))
    return [Field(f) for f in ref['fields']], ref


@functools.lru_cache(maxsize=None)
def port_solve(case, epsilon_r=False, warm=False):
    model, sfields = problem(t3, epsilon_r)
    efields = port_solve(case, epsilon_r)[0] if warm else None
    return t3.solve_batch_fields(model, sfields, efields=efields,
                                 device='cpu', **CASES[case])


def assert_lanes(port, ref, tol=1e-10):
    (out_t, info_t), (out_j, info_j) = port, ref
    assert (info_t['it_mg'], info_t['it_ssl']) == (info_j['it_mg'],
                                                   info_j['it_ssl'])
    assert list(info_t['exit_messages']) == list(info_j['exit_messages'])
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        assert a.field.dtype == np.complex128
        assert (np.linalg.norm(a.field - b.field)
                <= tol * np.linalg.norm(b.field))
    assert_allclose(info_t['rel_error'], info_j['rel_error'], rtol=1e-6)


def test_solve_batch_equals_jax():
    port = port_solve('plain')
    ref = jax_solve('batch.plain', CASES['plain'])
    assert_lanes(port, ref)
    assert port[1]['exit_messages'] == ['CONVERGED'] * len(FREQS)
    assert np.all(port[1]['rel_error'] < 1e-8)


def test_warm_start_converged_does_nothing():
    port = port_solve('plain', warm=True)
    assert_lanes(port, jax_solve('batch.plain.warm', CASES['plain'],
                                 warm=True))
    assert port[1]['it_mg'] == 0
    assert port[1]['exit_messages'] == ['CONVERGED'] * len(FREQS)
    for a, b in zip(port[0], port_solve('plain')[0]):
        assert np.array_equal(a.field, b.field)


@pytest.mark.parametrize('case', list(CASES))
def test_lanes_equal_sequential_solve(case):
    out, info = port_solve(case)
    model, sfields = problem(t3)
    kw = dict(CASES[case])
    for key in ('sslsolver', 'semicoarsening', 'linerelaxation'):
        kw.setdefault(key, False)
    if case == 'plain':
        # Every lane of a plain batch cycles until all have converged:
        # the same number of cycles alone.
        kw.update(maxit=info['it_mg'], tol=1e-30)
    for lane, sf in zip(out, sfields):
        ef, inf = t3.solve(model, sf, device='cpu', return_info=True, **kw)
        if case == 'plain':
            assert inf['it_mg'] == info['it_mg']
            tol = 1e-12
        else:
            assert inf['exit'] == 0
            tol = 1e-6
        assert (np.linalg.norm(lane.field - ef.field)
                <= tol * np.linalg.norm(ef.field))


def test_solve_batch_sources_and_errors():
    """solve_batch builds the source fields; a mismatch, a Krylov method
    with no batched form and no card raise."""
    model, sfields = problem(t3)
    out, info = t3.solve_batch(model, [SOURCE] * 3, FREQS, device='cpu',
                               **CASES['plain'])
    for a, b in zip(out, port_solve('plain')[0]):
        assert np.array_equal(a.field, b.field)
    assert set(info) == {'it_mg', 'it_ssl', 'abs_error', 'rel_error',
                         'ref_error', 'exit_messages', 'tol', 'runtime'}
    with pytest.raises(ValueError, match='equal length'):
        t3.solve_batch(model, [SOURCE], FREQS, device='cpu')
    with pytest.raises(ValueError, match='no batched form'):
        t3.solve_batch_fields(model, sfields, sslsolver='cgs', device='cpu')
    model2 = t3.Model(t3.TensorMesh([np.ones(8) * 200.0, np.ones(8) * 200.0,
                                     np.ones(4) * 400.0],
                                    origin=(-800.,) * 3), property_x=1.0)
    vmodels = [models.VolumeModel(model, sfields[0]),
               models.VolumeModel(model2, t3.get_source_field(
                   model2.grid, SOURCE, 1.0))]
    with pytest.raises(ValueError, match='same grid hierarchy'):
        tbatch._build_hierarchy_batched(
            vmodels, 0, 0, 2, torch.device('cpu'),
            (torch.complex128, torch.float64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t3.solve_batch_fields(model, sfields)


# ---------------------------------------------------------------------------
# The guards of the batched BiCGSTAB (tests/test_batch_engine.py:205-287),
# against the JAX functions on the same numpy inputs.
# ---------------------------------------------------------------------------

def _shapes(n):
    return [(n, n + 1, n + 1), (n + 1, n, n + 1), (n + 1, n + 1, n)]


def test_guarded_div_equals_jax():
    num = np.asarray([1.0, 1.0, 1.0, 3.0 - 1.0j], dtype=np.complex64)
    den = np.asarray([0.0, 1e-45, 2.0, 1.0 + 2.0j], dtype=np.complex64)
    out = tbatch._guarded_div(torch.from_numpy(num), torch.from_numpy(den))
    ref = np.asarray(jbatch._guarded_div(jnp.asarray(num), jnp.asarray(den)))
    assert out[0] == 0 and out[1] == 0
    assert np.isfinite(out.numpy()).all()
    assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_bcg_direction_nonfinite_beta_equals_jax():
    shp = [(2,) + s for s in _shapes(3)]
    r = [np.ones(s, np.complex64) for s in shp]
    z = [np.zeros(s, np.complex64) for s in shp]
    big = np.asarray([1e30, 1.0], np.complex64)
    tiny = np.asarray([1e-30, 1.0], np.complex64)
    args = (r, r, z, z, tiny * tiny, big, tiny)
    p_t, rho_t = tbatch._bcg_direction(
        *([torch.from_numpy(c) for c in a] if isinstance(a, list)
          else torch.from_numpy(a) for a in args), first=False)
    p_j, rho_j = jbatch._bcg_direction(
        *(tuple(jnp.asarray(c) for c in a) if isinstance(a, list)
          else jnp.asarray(a) for a in args), first=False)
    for a, b in zip(p_t, p_j):
        assert np.isfinite(a.numpy()).all()
        assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert_allclose(rho_t.numpy(), np.asarray(rho_j), rtol=1e-6)


def test_bcg_advance_freezes_converged_lane_as_jax():
    rng = np.random.default_rng(11)
    n = 3
    eta = (-(rng.uniform(1e3, 5e3, (n, n, n)))
           + 1j * rng.uniform(1e2, 5e2, (n, n, n))).astype(np.complex64)
    zeta = rng.uniform(1e3, 2e3, (n, n, n)).astype(np.float32)
    h = [rng.uniform(20, 60, n).astype(np.float32) for _ in range(3)]
    ops = tuple(torch.from_numpy(a) for a in (eta, eta, eta, zeta, *h))
    lvl = solver._Level(ops, ops64=ops)
    arrs = dict(zip(('eta_x', 'eta_y', 'eta_z', 'zeta', 'hx', 'hy', 'hz'),
                    (jnp.asarray(a) for a in (eta, eta, eta, zeta, *h))))
    shp = [(2,) + s for s in _shapes(n)]
    x = [np.full(s, 2.0 + 1.0j, np.complex64) for s in shp]
    one = [np.ones(s, np.complex64) for s in shp]
    alpha = np.asarray([np.nan, 1.0], np.complex64)
    active = np.asarray([False, True])

    def tt(a):
        return tuple(torch.from_numpy(c) for c in a)

    def jj(a):
        return tuple(jnp.asarray(c) for c in a)

    x_t, r_t, om_t, rn_t = tbatch._bcg_advance(
        tt(one), tt(one), tt(one), tt(x), torch.from_numpy(alpha),
        torch.from_numpy(active), lvl)
    x_j, r_j, om_j, rn_j = jbatch._bcg_advance(
        jj(one), jj(one), jj(one), jj(x), jnp.asarray(alpha),
        jnp.asarray(active), arrs)
    for a, b, c in zip(x_t, x_j, x):
        # Lane 0 (converged): bit-identical freeze despite NaN alpha.
        assert np.array_equal(a[0].numpy(), c[0])
        # Lane 1 (active): really updated, as in the JAX package.
        assert np.isfinite(a[1].numpy()).all()
        assert not np.allclose(a[1].numpy(), c[1])
        assert_allclose(a[1].numpy(), np.asarray(b[1]), rtol=1e-4)
    assert_allclose(rn_t[1].numpy(), np.asarray(rn_j[1]), rtol=1e-4)


@pytest.mark.parametrize('ntask,n_active', [
    (16, 3), (16, 5), (4, 3), (4, 4), (8, 1), (6, 3), (3, 1), (5, 0)])
def test_shrink_size_equals_jax(ntask, n_active):
    assert (tbatch._shrink_size(ntask, n_active)
            == jbatch._shrink_size(ntask, n_active, 1))


@pytest.mark.parametrize('active,new_n', [
    ([False, True, False, True], 2),
    ([False, True, False, False, True, False], 3),
    ([True, False, False], 1)])
def test_keep_lanes_equals_jax(active, new_n):
    active = np.asarray(active)
    assert np.array_equal(tbatch._keep_lanes(active, new_n),
                          jbatch._keep_lanes(active, new_n))


# ---------------------------------------------------------------------------
# Operator, transfers and the plain smoothers on a leading task axis.
# ---------------------------------------------------------------------------

def _random_lanes(shape, ntask=3, seed=4):
    """Fields, sources (ntask, ...), stacked eta, shared eta, zeta and
    widths, per-task scales; complex128 from a numpy seed."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)

    def c(*s):
        return torch.from_numpy(rng.normal(size=s) + 1j * rng.normal(size=s))

    edges = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz)]
    e = [c(ntask, *s) for s in edges]
    s = [c(ntask, *s) for s in edges]
    eta = [torch.from_numpy(-rng.uniform(1, 5, (ntask, *shape))
                            + 1j * rng.uniform(1, 5, (ntask, *shape)))
           for _ in range(3)]
    zeta = torch.from_numpy(rng.uniform(1e3, 2e3, shape))
    h = [torch.from_numpy(rng.uniform(20.0, 60.0, n)) for n in shape]
    scale = torch.from_numpy(rng.uniform(0.5, 2, ntask)
                             + 1j * rng.uniform(-1, 1, ntask))
    return e, s, eta, [c[0] for c in eta], [zeta, *h], scale


def test_operator_on_task_axis_equals_lanes():
    e, s, eta, shared, rest, scale = _random_lanes((5, 4, 6))
    for eta_b, eta_of in ((eta, lambda k: [c[k] for c in eta]),
                          (solver._scaled((*shared, *rest), scale)[:3],
                           lambda k: [scale[k] * c for c in shared])):
        out = operator.amat_x(*e, *eta_b, *rest)
        res = operator.residual(*s, *e, *eta_b, *rest)
        norms = operator.residual_norm(*res, per_task=True)
        assert norms.shape == (3,)
        for k in range(3):
            ref = operator.amat_x(*(c[k] for c in e), *eta_of(k), *rest)
            for a, b in zip(out, ref):
                assert_allclose(a[k].numpy(), b.numpy(), rtol=1e-14,
                                atol=1e-14 * b.abs().max().item())
            rk = operator.residual(*(c[k] for c in s), *(c[k] for c in e),
                                   *eta_of(k), *rest)
            assert_allclose(norms[k].item(),
                            operator.residual_norm(*rk).item(), rtol=1e-14)
    lvl = solver._Level((*shared, *rest), ops64=(*shared, *rest),
                        scale=scale, scale64=scale)
    zeros = [torch.zeros_like(c) for c in e]
    r, l2 = solver._residual_norm_split(e, zeros, s, lvl, per_task=True)
    assert_allclose(l2.numpy(), norms.numpy(), rtol=1e-14)
    assert_allclose(torch.cat([c.flatten() for c in r]).numpy(),
                    torch.cat([c.flatten() for c in res]).numpy(), rtol=1e-14,
                    atol=1e-14)


@pytest.mark.parametrize('coarsen', [(True, True, True), (False, True, True),
                                     (True, False, True), (True, True,
                                                           False)])
def test_transfers_on_task_axis_equal_lanes(coarsen):
    shape = (8, 6, 4)
    e, s, _, _, rest, _ = _random_lanes(shape)
    model = t3.Model(t3.TensorMesh([r.numpy() for r in rest[1:]],
                                   origin=(0., 0., 0.)), property_x=1.0)
    sfield = t3.Field(model.grid, frequency=1.0)
    vm = models.VolumeModel(model, sfield)
    sc_dir = {(True, True, True): 0, (False, True, True): 1,
              (True, False, True): 2, (True, True, False): 3}[coarsen]
    _, levels = solver._build_hierarchy(
        vm, sc_dir, 0, 1, torch.device('cpu'),
        (torch.complex128, torch.float64))
    lvl = levels[0]
    coarse = transfer.restrict(*e, lvl.rw, coarsen)
    fine = [c.clone() for c in e]
    transfer.prolong(*fine, *coarse, lvl.pm, coarsen)
    for k in range(3):
        ref = transfer.restrict(*(c[k] for c in e), lvl.rw, coarsen)
        for a, b in zip(coarse, ref):
            assert torch.equal(a[k], b)
        lane = [c[k].clone() for c in e]
        transfer.prolong(*lane, *ref, lvl.pm, coarsen)
        for a, b in zip(fine, lane):
            assert torch.equal(a[k], b)
    # restrict_model_parameters keeps working on (numpy) cell arrays.
    assert (transfer.restrict_model_parameters(np.ones(shape), coarsen).sum()
            == np.prod(shape))


@pytest.mark.parametrize('layout', ['stacked', 'shared', 'scaled'])
def test_plain_smoothers_on_task_axis_equal_lanes(layout):
    """The twins with a task axis (the oracle of the kernels' task index)
    equal today's twins on each lane, bit for bit: point smoother nu=2,
    line smoother nu=1 along each axis."""
    shape = (5, 4, 6)
    e, s, eta, shared, rest, scale = _random_lanes(shape)
    eta_b, sc, eta_of = {
        'stacked': (eta, None, lambda k: [c[k] for c in eta]),
        'shared': (shared, None, lambda k: shared),
        'scaled': (shared, scale, lambda k: [scale[k] * c for c in shared]),
    }[layout]
    runs = [(smoothers.gauss_seidel, (2,))]
    runs += [(smoothers.gauss_seidel_line, (1, axis)) for axis in range(3)]
    for fn, args in runs:
        out = [c.clone() for c in e]
        fn(*out, *s, *eta_b, *rest, *args, scale=sc)
        for k in range(3):
            lane = [c[k].clone() for c in e]
            fn(*lane, *(c[k] for c in s), *eta_of(k), *rest, *args)
            for a, b in zip(out, lane):
                assert torch.equal(a[k], b)
            assert any(not torch.equal(a[k], c[k]) for a, c in zip(out, e))
