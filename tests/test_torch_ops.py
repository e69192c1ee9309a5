"""PyTorch port, operator and transfer ops against the JAX package.

Same numpy inputs through ``emg3d_tpu.ops`` (JAX, x64 on the CPU) and
``emg3d_tpu_torch.ops`` (complex128 on the CPU); results agree to
rtol 1e-12 (same arithmetic, possibly another summation order).  The
JAX package's ``amat_x``, ``residual`` and ``residual_norm``, whose
operations compile one by one for seconds, are read from
tests/data/torch_reference.npz (written by
tests/create_data/torch_reference.py from the JAX package).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from emg3d_tpu import meshes
from emg3d_tpu.ops import transfer
from emg3d_tpu_torch.ops import operator as t_operator
from emg3d_tpu_torch.ops import transfer as t_transfer
from torch_reference import fields, reference

RTOL = 1e-12


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(rng, nx, ny, nz):
    shp = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz)]
    return tuple(rng.normal(size=s) + 1j * rng.normal(size=s) for s in shp)


def _problem(seed=5, nx=9, ny=8, nz=7):
    """Random fields and a stretched, anisotropic model (numpy)."""
    rng = np.random.default_rng(seed)
    h = tuple(rng.uniform(20, 60, n) for n in (nx, ny, nz))
    e = _edges(rng, nx, ny, nz)
    s = _edges(rng, nx, ny, nz)
    eta = tuple(-rng.uniform(1e3, 5e3, (nx, ny, nz))
                + 1j * rng.uniform(1e2, 5e2, (nx, ny, nz)) for _ in range(3))
    zeta = rng.uniform(1e3, 2e3, (nx, ny, nz))
    return e, s, eta, zeta, h


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _close(out, ref, rtol=RTOL):
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * np.abs(b).max())


def test_amat_residual_norm():
    e, s, eta, zeta, h = _problem()
    model = [*eta, zeta, *h]
    # operator.amat_x(e), residual(s, e) and its residual_norm of the JAX
    # package on the same operands.
    stored = reference('ops.amat_residual', _problem())
    ref = fields(stored['amat'])
    out = t_operator.amat_x(*_t(e), *_t(model))
    _close(out, ref)

    ref = fields(stored['residual'])
    out = t_operator.residual(*_t(s), *_t(e), *_t(model))
    _close(out, ref)
    assert_allclose(float(t_operator.residual_norm(*out)),
                    stored['residual_norm'], rtol=RTOL)


def _level_pair(coarsen, seed=7, shape=(8, 6, 4)):
    """A stretched fine grid, its coarse grid under ``coarsen``, and the
    1-D transfer metadata per coarsened axis (numpy, from emg3d_tpu)."""
    rng = np.random.default_rng(seed)
    h = [rng.uniform(30, 90, n) for n in shape]
    origin = (-100., -50., -70.)
    ch = [np.diff(np.r_[0., h[i].cumsum()][::2]) if coarsen[i] else h[i]
          for i in range(3)]
    grid, cgrid = meshes.BaseMesh(h, origin), meshes.BaseMesh(ch, origin)
    rw, pm = [], []
    for i, c in enumerate('xyz'):
        if not coarsen[i]:
            rw.append(None)
            pm.append(None)
            continue
        args = (getattr(grid, 'nodes_' + c),
                getattr(grid, 'cell_centers_' + c), h[i],
                getattr(cgrid, 'nodes_' + c),
                getattr(cgrid, 'cell_centers_' + c), ch[i])
        w = transfer.restrict_weights(*args)
        for a, b in zip(t_transfer.restrict_weights(*args), w):
            assert_allclose(a, b, rtol=0)
        rw.append(w)
        pargs = (getattr(cgrid, 'nodes_' + c), getattr(grid, 'nodes_' + c))
        idx, wp = transfer.prolong_meta(*pargs)
        tidx, twp = t_transfer.prolong_meta(*pargs)
        assert_allclose(tidx, idx, rtol=0)
        assert_allclose(twp, wp, rtol=0)
        pm.append((idx, wp))
    return rng, grid.shape_cells, cgrid.shape_cells, rw, pm


COARSEN = [c for c in itertools.product((False, True), repeat=3) if any(c)]


@pytest.mark.parametrize('coarsen', COARSEN)
def test_restrict_prolong(coarsen):
    rng, shape, cshape, rw, pm = _level_pair(coarsen)
    r = _edges(rng, *shape)
    jrw = tuple(None if w is None else tuple(_j(w)) for w in rw)
    trw = tuple(None if w is None else tuple(_t(w)) for w in rw)
    ref = transfer.restrict(*_j(r), jrw, coarsen)
    out = t_transfer.restrict(*_t(r), trw, coarsen)
    _close(out, ref)

    param = rng.uniform(1, 2, shape)
    assert_allclose(t_transfer.restrict_model_parameters(param, coarsen),
                    np.asarray(transfer.restrict_model_parameters(
                        jnp.asarray(param), coarsen)), rtol=RTOL)

    ce = _edges(rng, *cshape)
    e = _edges(rng, *shape)
    jpm = tuple(None if p is None else (jnp.asarray(p[0]), jnp.asarray(p[1]))
                for p in pm)
    tpm = tuple(None if p is None else (torch.from_numpy(p[0]).long(),
                                        torch.from_numpy(p[1])) for p in pm)
    ref = transfer.prolong(*_j(e), *_j(ce), jpm, coarsen)
    te = _t(e)
    out = t_transfer.prolong(*te, *_t(ce), tpm, coarsen)
    assert all(a is b for a, b in zip(out, te))      # updated in place
    _close(out, ref)
