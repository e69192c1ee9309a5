"""PyTorch port, volume averaging and its adjoint as three 1-D weight
matrices, on the CPU.

``maps.interp_volume_average_adj`` maps values on a computational grid
back onto the inversion mesh (the transpose of
``maps.interpolate(..., method='volume')``) with one 1-D weight matrix
per axis, contracted axis by axis.  It is held against the 3-D scatter
it replaces, kept verbatim below as the oracle
(``_scatter_volume_average_adj``), to 1e-13 of the largest entry, and
against the forward map by a dot-product test, on grid pairs
where the computational grid reaches past the mesh on one axis and lies
inside it on another, where the nodes of one axis coincide, and with a
one-cell axis, for 1 and 3 leading components.  It adds into ``oval``
and returns that array.

The forward map, ``maps.interp_volume_average`` (three sparse 1-D
matrices, applied axis by axis), is held against the 3-D scatter it
replaces, kept verbatim below (``_scatter_volume_average``), to 1e-13
of the largest entry, on the same grid pairs, for C- and
Fortran-ordered values; it adds into ``new_values`` and divides by the
new cells' volumes.

The counter ``gradient_regrid_tasks`` grows by the (source, frequency)
tasks of a gradient whose computational grids differ from the model's
grid, by 0 where they are the model's grid, and is carried by the
``emg3d.sim.gradient`` root's counts; the benchmark's reader
``survey.gradient_regrid_tasks_per_step`` reads it per iterate.

BLAS and torch run on one thread (the test workers share the cores).
"""

import pathlib
import sys

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu_torch import maps, tracing

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmark import harness  # noqa: E402


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


# --- The 3-D scatter, verbatim: the oracle --------------------------------

def _scatter_volume_average_adj(oval, ogrid, nval, ngrid):
    """In-place adjoint of conservative volume averaging.

    The reference delegates to discretize (emg3d/maps.py:723-756); here
    the adjoint is assembled natively from the same merged-node weights
    as the forward map: forward is ``new[o] = Σ_i w_io val[i] / V_n[o]``,
    so the adjoint is ``oval[i] += Σ_o w_io nval[o] / V_n[o]``.

    ``oval``/``nval`` have shape (3, \\*grid.shape_cells); used to bring
    adjoint-state gradients from computational grids back to the
    inversion grid (reference simulations.py:1064-1067).
    """
    wx, ixi, ixo = maps._volume_average_weights(ogrid.nodes_x, ngrid.nodes_x)
    wy, iyi, iyo = maps._volume_average_weights(ogrid.nodes_y, ngrid.nodes_y)
    wz, izi, izo = maps._volume_average_weights(ogrid.nodes_z, ngrid.nodes_z)

    vol_n = ngrid.cell_volumes.reshape(ngrid.shape_cells, order="F")
    for c in range(oval.shape[0]):
        scaled = nval[c] / vol_n
        contrib = (wx[:, None, None] * wy[None, :, None]
                   * wz[None, None, :] * scaled[np.ix_(ixo, iyo, izo)])
        np.add.at(oval[c], np.ix_(ixi, iyi, izi), contrib)
    return oval


def _scatter_volume_average(nodes_x, nodes_y, nodes_z, values, new_nodes_x,
                            new_nodes_y, new_nodes_z, new_values, new_vol):
    """Conservative volume-average regridding of cell properties.

    Vectorized scatter-add version of the reference's numba kernel
    (emg3d/maps.py:555-616; discretize/Capriotti algorithm).  The result is
    added to ``new_values`` and normalized by the new cell volumes.
    """
    wx, ixi, ixo = maps._volume_average_weights(nodes_x, new_nodes_x)
    wy, iyi, iyo = maps._volume_average_weights(nodes_y, new_nodes_y)
    wz, izi, izo = maps._volume_average_weights(nodes_z, new_nodes_z)

    # Outer product of contributions; scatter-add into the output cells.
    contrib = (wx[:, None, None] * wy[None, :, None] * wz[None, None, :]
               * values[np.ix_(ixi, iyi, izi)])
    np.add.at(new_values, np.ix_(ixo, iyo, izo), contrib)
    new_values /= new_vol
    return new_values


# --- The grid pairs: (mesh, computational grid) ---------------------------

def _mesh(widths, origin):
    return t3.TensorMesh([np.asarray(w, dtype=float) for w in widths],
                         origin=origin)


_RNG = np.random.default_rng(20261018)
# Whole metres on y, so that sums of its widths are exact.
_OX, _OZ = _RNG.uniform(60., 140., 7), _RNG.uniform(60., 140., 5)
_OY = _RNG.integers(60, 140, 6).astype(float)

PAIRS = {
    # x: the grid reaches past the mesh on both sides; y: it lies inside
    # the mesh; z: it starts inside and ends beyond.
    'past_and_inside': (
        _mesh([_OX, _OY, _OZ], (0., 0., 0.)),
        _mesh([_RNG.uniform(200., 260., 6), _RNG.uniform(40., 55., 5),
               _RNG.uniform(150., 200., 5)],
              (-150., 30., 110.))),
    # y: the grid's nodes are every other node of the mesh; x: the grid
    # is finer than the mesh.
    'coinciding_nodes': (
        _mesh([_OX, _OY, _OZ], (0., 0., 0.)),
        _mesh([_RNG.uniform(30., 70., 14), _OY[:4].reshape(2, 2).sum(1),
               _RNG.uniform(50., 130., 4)],
              (-40., 0., 20.))),
    # z: one cell in the grid, reaching past the mesh; x: one cell in
    # the mesh.
    'one_cell_axis': (
        _mesh([[250.], _OY, _OZ], (10., 0., 0.)),
        _mesh([_RNG.uniform(60., 120., 5), _RNG.uniform(90., 150., 5),
               [700.]],
              (-30., -20., -100.))),
}


def _values(ngrid, ncomp, seed):
    rng = np.random.default_rng(seed)
    return np.asfortranarray(
        rng.standard_normal((ncomp, *ngrid.shape_cells)))


@pytest.mark.parametrize('ncomp', [1, 3])
@pytest.mark.parametrize('pair', list(PAIRS))
def test_equals_scatter(pair, ncomp):
    ogrid, ngrid = PAIRS[pair]
    nval = _values(ngrid, ncomp, 1)
    new = maps.interp_volume_average_adj(
        np.zeros((ncomp, *ogrid.shape_cells), order='F'), ogrid, nval, ngrid)
    old = _scatter_volume_average_adj(
        np.zeros((ncomp, *ogrid.shape_cells), order='F'), ogrid, nval, ngrid)
    scale = np.abs(old).max()
    assert scale > 0
    assert np.abs(new - old).max() <= 1e-13 * scale


@pytest.mark.parametrize('order', ['C', 'F'])
@pytest.mark.parametrize('pair', list(PAIRS))
def test_forward_equals_scatter(pair, order):
    ogrid, ngrid = PAIRS[pair]
    values = np.asarray(np.random.default_rng(6).uniform(
        0.3, 100., ogrid.shape_cells), order=order)
    start = np.random.default_rng(7).standard_normal(ngrid.shape_cells)
    vol = ngrid.cell_volumes.reshape(ngrid.shape_cells, order='F')
    nodes = (ogrid.nodes_x, ogrid.nodes_y, ogrid.nodes_z,
             values, ngrid.nodes_x, ngrid.nodes_y, ngrid.nodes_z)
    new_values = start.copy()
    out = maps.interp_volume_average(*nodes, new_values, vol)
    assert out is new_values
    old = _scatter_volume_average(*nodes, start.copy(), vol)
    scale = np.abs(old).max()
    assert scale > 0
    assert np.abs(out - old).max() <= 1e-13 * scale


@pytest.mark.parametrize('ncomp', [1, 3])
@pytest.mark.parametrize('pair', list(PAIRS))
def test_transpose_of_forward(pair, ncomp):
    ogrid, ngrid = PAIRS[pair]
    rng = np.random.default_rng(2)
    v = rng.standard_normal(ogrid.shape_cells)
    w = _values(ngrid, ncomp, 3)

    fwd = maps.interpolate(grid=ogrid, values=v, xi=ngrid, method='volume',
                           extrapolate=True, log=False)
    lhs = np.sum(fwd[None] * w)

    adj = maps.interp_volume_average_adj(
        np.zeros((ncomp, *ogrid.shape_cells)), ogrid, w, ngrid)
    rhs = np.sum(v[None] * adj)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize('pair', list(PAIRS))
def test_adds_in_place(pair):
    ogrid, ngrid = PAIRS[pair]
    nval = _values(ngrid, 3, 4)
    start = np.random.default_rng(5).standard_normal(
        (3, *ogrid.shape_cells))
    oval = np.asfortranarray(start.copy())
    out = maps.interp_volume_average_adj(oval, ogrid, nval, ngrid)
    assert out is oval
    added = _scatter_volume_average_adj(
        np.zeros_like(start), ogrid, nval, ngrid)
    np.testing.assert_allclose(oval, start + added, rtol=0,
                               atol=1e-13 * np.abs(start + added).max())


# --- The counter and its reader -------------------------------------------

FREQS = [1.0, 2.0]
SOURCES = [(-30., 10., 0., 0., 0.), (40., -20., 10., 0., 0.)]
RECEIVERS = [(x, 60., -20., 0., 0.) for x in (-120., 130.)]
# A mesh of 8^3 cells of 40 m, and a stretched computational grid of
# 8^3 cells that covers it.
MESH = t3.TensorMesh([np.full(8, 40.)] * 3, origin=(-160.,) * 3)
GRID = t3.TensorMesh(
    [np.array([90., 60., 45., 40., 40., 45., 60., 90.])] * 3,
    origin=(-235.,) * 3)


def _simulation(gridding):
    survey = t3.Survey([t3.TxElectricPoint(s) for s in SOURCES],
                       [t3.RxElectricPoint(r) for r in RECEIVERS], FREQS,
                       relative_error=0.05, noise_floor=1e-15)
    model = t3.Model(MESH, property_x=2.0, mapping='Resistivity')
    opts = {'gridding_opts': GRID} if gridding == 'input' else {}
    sim = t3.Simulation(
        survey, model, gridding=gridding, receiver_interpolation='linear',
        tqdm_opts=False, device='cpu',
        solver_opts={'tol': 1e-3, 'linerelaxation': False,
                     'semicoarsening': False, 'cycle': 'V', 'nu_pre': 1,
                     'nu_post': 1, 'verb': 0}, **opts)
    sim.compute(observed=True, add_noise=False)
    sim.data['observed'] = 1.5 * sim.data['observed']
    return sim


@pytest.mark.parametrize('gridding, tasks', [('input', 4), ('same', 0)])
def test_counter_counts_regridded_tasks(gridding, tasks):
    sim = _simulation(gridding)
    source = list(sim.survey.sources)[0]
    assert (sim.get_grid(source, 'f-1') == MESH) == (gridding == 'same')
    tracing.clear()
    try:
        before = tracing.counts()['gradient_regrid_tasks']
        with tracing.recording():
            _ = sim.gradient
        after = tracing.counts()['gradient_regrid_tasks']
        assert after - before == tasks
        roots = [s for s in tracing.spans()
                 if s.parent is None and s.name == 'emg3d.sim.gradient']
        assert len(roots) == 1
        assert roots[0].attrs['counts']['gradient_regrid_tasks'] == tasks
    finally:
        tracing.clear()


def test_reader_reads_regridded_tasks():
    # The benchmark's reader over two synthetic iterate roots, each
    # mapping the gradients of two tasks back to the mesh.
    read = harness.load_module(
        harness.HERE / 'metrics'
        / 'survey.gradient_regrid_tasks_per_step.py').read
    tracing.clear()
    try:
        with tracing.recording():
            for _ in range(2):
                with tracing.span('emg3d.sim.gradient'):
                    tracing.count('gradient_regrid_tasks', 2)
        assert read({'profile': {'answers': 2}}) == 2.0
        assert read({'profile': {'answers': 1}}) is None
    finally:
        tracing.clear()
