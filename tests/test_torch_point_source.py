"""PyTorch port, electric point-source fields built from their entries,
on the CPU.

``get_source_field`` with a ``TxElectricPoint`` and
``Simulation._get_rfield`` write an electric point source's field at its
at most 24 entries (``fields._point_entries``) instead of building it
from full-grid arrays.  Both are held bit for bit (``np.array_equal``)
against the dense construction they replace, kept verbatim below as the
oracle (``_dense_point_vector``, ``_dense_source_field``,
``_dense_rfield``), on a stretched grid of unequal sides at 1 Hz and in
the Laplace domain: a point inside a cell, on a node, in the last cell
of an axis (the two positions along it coincide), two points in one
cell, a rotated point (negative direction components), a receiver whose
residual is NaN (left out), a magnetic receiver (its dense field added),
and a point outside the grid (``ValueError``).  The counters
``rfield_receivers`` and ``rfield_point_receivers`` grow by the
receivers used and the electric ones among them; the benchmark's reader
``survey.rfield_point_receivers_per_step`` reads the latter.

BLAS and torch run on one thread (the test workers share the cores).
"""

import pathlib
import sys

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu_torch import electrodes, fields, tracing

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmark import harness  # noqa: E402


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


# --- The dense construction, verbatim: the oracle -------------------------

def _dense_point_vector(grid, coordinates):
    """Point source via the adjoint of trilinear interpolation.

    Reference: emg3d/fields.py:662-745.
    """
    outside = (
        coordinates[0] < grid.nodes_x[0] or
        coordinates[0] > grid.nodes_x[-1] or
        coordinates[1] < grid.nodes_y[0] or
        coordinates[1] > grid.nodes_y[-1] or
        coordinates[2] < grid.nodes_z[0] or
        coordinates[2] > grid.nodes_z[-1])
    if outside:
        raise ValueError(f"Provided source outside grid: {coordinates}.")

    def adjoint_interp(xx, yy, zz, coo, s):
        """Scatter unit strength to the 8 surrounding positions of coo."""
        nx, ny, nz = s.shape

        def cell_index(cc, coo_c):
            return max(0, int(np.searchsorted(np.r_[cc, np.inf], coo_c,
                                              side="right")) - 1)

        ix = cell_index(xx, coo[0])
        iy = cell_index(yy, coo[1])
        iz = cell_index(zz, coo[2])

        def frac(ic, nc, csrc, cc):
            if ic == nc - 1:
                return 1.0, 1.0, ic
            ic1 = ic + 1
            rc = (csrc - cc[ic]) / (cc[ic1] - cc[ic])
            return rc, 1.0 - rc, ic1

        rx, ex, ix1 = frac(ix, nx, coo[0], xx)
        ry, ey, iy1 = frac(iy, ny, coo[1], yy)
        rz, ez, iz1 = frac(iz, nz, coo[2], zz)

        s[ix, iy, iz] = ex * ey * ez
        s[ix1, iy, iz] = rx * ey * ez
        s[ix, iy1, iz] = ex * ry * ez
        s[ix1, iy1, iz] = rx * ry * ez
        s[ix, iy, iz1] = ex * ey * rz
        s[ix1, iy, iz1] = rx * ey * rz
        s[ix, iy1, iz1] = ex * ry * rz
        s[ix1, iy1, iz1] = rx * ry * rz

    vfield = fields.Field(grid, dtype=float)
    fx = np.zeros(grid.shape_edges_x)
    fy = np.zeros(grid.shape_edges_y)
    fz = np.zeros(grid.shape_edges_z)

    adjoint_interp(grid.cell_centers_x, grid.nodes_y, grid.nodes_z,
                   coordinates[:3], fx)
    adjoint_interp(grid.nodes_x, grid.cell_centers_y, grid.nodes_z,
                   coordinates[:3], fy)
    adjoint_interp(grid.nodes_x, grid.nodes_y, grid.cell_centers_z,
                   coordinates[:3], fz)

    srcdir = electrodes.rotation(*coordinates[3:])
    vfield.fx = fx * srcdir[0]
    vfield.fy = fy * srcdir[1]
    vfield.fz = fz * srcdir[2]

    return vfield


def _dense_source_field(grid, source, frequency):
    """``get_source_field``'s dense path for a ``TxElectricPoint``."""
    vfield = _dense_point_vector(grid, source.coordinates)

    sfield = fields.Field(grid, data=vfield.field, frequency=frequency)
    sfield.field = sfield.field * source.strength
    if frequency is not None:
        sfield.field = sfield.field * (-sfield.smu0)

    return sfield


def _dense_rfield(self, source, frequency):
    """``Simulation._get_rfield``, every receiver's field dense."""
    freq = self.survey.frequencies[frequency]

    grid = self.get_grid(source, frequency)
    residual = self.data.residual.loc[source, :, frequency]
    weight = self.data.weights.loc[source, :, frequency]

    rfield = fields.Field(grid, frequency=freq)

    # Weighted residual, normalized by -smu0, conjugated.
    strength = np.conj(residual * weight / -rfield.smu0)

    receivers = [(i, rec) for i, rec in
                 enumerate(self.survey.receivers.values())
                 if not np.isnan(residual[i])]
    for i, rec in receivers:
        coords = rec.coordinates_abs(self.survey.sources[source])
        src = rec._adjoint_source(coords, strength=strength[i])
        if isinstance(src, electrodes.TxElectricPoint):
            sfield = _dense_source_field(grid, src, freq)
        else:
            sfield = src.get_field(grid=grid, frequency=freq)
        rfield.field = rfield.field + sfield.field

    return rfield


# --- The cases ------------------------------------------------------------

# A stretched grid of 7 x 9 x 6 cells, centred near 0.
GRID = t3.TensorMesh(
    [np.array([140., 110., 100., 90., 100., 120., 150.]),
     np.array([160., 120., 100., 80., 80., 80., 100., 120., 160.]),
     np.array([130., 100., 90., 90., 110., 140.])],
    origin=(-350., -460., -280.))
SOURCES = [(-20., 10., 5., 0., 0.), (30., -15., -10., 0., 0.)]
NODE = (GRID.nodes_x[3], GRID.nodes_y[4], GRID.nodes_z[2])
# Beyond the last cell centre of x and on the last node of y: the x and
# y positions coincide there in every component that has them.
LAST = (0.5 * (GRID.cell_centers_x[-1] + GRID.nodes_x[-1]),
        GRID.nodes_y[-1], GRID.cell_centers_z[2] + 7.)


def _rx(x, y, z, azimuth=0., elevation=0., magnetic=False):
    cls = t3.RxMagneticPoint if magnetic else t3.RxElectricPoint
    return cls((x, y, z, azimuth, elevation))


CASES = {
    'interior': (1.0, [_rx(40., -60., 30.), _rx(-110., 85., -45., 60.)],
                 ()),
    'node': (1.0, [_rx(*NODE), _rx(*NODE, 90., 0.), _rx(*NODE, 0., 90.)],
             ()),
    'last_cell': (1.0, [_rx(*LAST), _rx(*LAST, 45., 30.)], ()),
    'two_in_one_cell': (1.0, [_rx(12., 18., 22.), _rx(31., 44., 27.)], ()),
    'rotated': (1.0, [_rx(-70., 25., 15., 30., -20.)], ()),
    'nan_residual': (1.0, [_rx(40., -60., 30.), _rx(-90., 30., 10.),
                           _rx(75., 70., -35., 10., 5.)], (1,)),
    'magnetic': (1.0, [_rx(40., -60., 30.),
                       _rx(-50., 20., 40., magnetic=True),
                       _rx(-110., 85., -45., 60.)], ()),
    'laplace': (-1.0, [_rx(40., -60., 30.), _rx(*LAST, 30., -20.),
                       _rx(*NODE, 120., 40.)], ()),
    'outside': (1.0, [_rx(40., -60., 30.), _rx(2000., 0., 0.)], ()),
}


def _simulation(frequency, receivers, nan):
    survey = t3.Survey([t3.TxElectricPoint(s) for s in SOURCES], receivers,
                       [frequency], relative_error=0.05, noise_floor=1e-15)
    model = t3.Model(GRID, property_x=2.0, mapping='Resistivity')
    sim = t3.Simulation(survey, model, gridding='same', tqdm_opts=False,
                        device='cpu')
    rng = np.random.default_rng(20261018)
    shape = survey.shape
    residual = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if frequency < 0:
        residual = residual.real + 0j
    residual[:, list(nan), :] = np.nan
    sim.data['residual'] = 1e-12 * residual
    sim.data['weights'] = 10 ** rng.uniform(20., 24., shape)
    return sim


@pytest.mark.parametrize('case', list(CASES))
def test_point_fields_equal_dense(case):
    frequency, receivers, nan = CASES[case]
    sim = _simulation(frequency, receivers, nan)

    # Each receiver's adjoint source alone, at the case's frequency and
    # with none, with its strength from the data.
    for i, rec in enumerate(receivers):
        if isinstance(rec, t3.RxMagneticPoint):
            continue
        src = t3.TxElectricPoint(rec.coordinates,
                                 strength=complex(1.5 - 0.5j * i))
        if case == 'outside' and i == 1:
            for build in (_dense_source_field, t3.get_source_field):
                with pytest.raises(ValueError, match='outside grid'):
                    build(GRID, src, frequency)
            continue
        for freq in (frequency, None):
            new = t3.get_source_field(GRID, src, freq)
            old = _dense_source_field(GRID, src, freq)
            assert new.field.dtype == old.field.dtype
            assert np.array_equal(new.field, old.field), (case, i, freq)
            assert np.count_nonzero(new.field) <= 24

    # The adjoint source fields of both sources.
    used = [i for i in range(len(receivers)) if i not in nan]
    points = [i for i in used
              if isinstance(receivers[i], t3.RxElectricPoint)]
    for source in sim.survey.sources:
        if case == 'outside':
            for build in (_dense_rfield, type(sim)._get_rfield):
                with pytest.raises(ValueError, match='outside grid'):
                    build(sim, source, 'f-1')
            continue
        before = tracing.counts()
        new = sim._get_rfield(source, 'f-1')
        after = tracing.counts()
        old = _dense_rfield(sim, source, 'f-1')
        assert new.field.dtype == old.field.dtype
        assert np.array_equal(new.field, old.field), (case, source)
        assert after['rfield_receivers'] - before['rfield_receivers'] == (
            len(used))
        assert (after['rfield_point_receivers']
                - before['rfield_point_receivers']) == len(points)


def test_point_entries_last_write_wins():
    # In the last cell of x the x-component's two x positions coincide:
    # 4 distinct entries there, not 8; the field holds each once.
    index, values = fields._point_entries(GRID, (*LAST, 0., 0.))
    assert np.unique(index).size == index.size
    nx = GRID.n_edges_x
    assert np.count_nonzero(index < nx) == 2     # y on its last node too
    dense = _dense_point_vector(GRID, (*LAST, 0., 0.)).field
    field = np.zeros_like(dense)
    field[index] = values
    assert np.array_equal(field, dense)


def test_reader_reads_point_receivers():
    # The benchmark's reader of the new counter, over one recorded
    # iterate root holding both adjoint sources of the mixed survey.
    read = harness.load_module(
        harness.HERE / 'metrics'
        / 'survey.rfield_point_receivers_per_step.py').read
    sim = _simulation(*CASES['magnetic'])
    tracing.clear()
    try:
        with tracing.recording():
            with tracing.span('emg3d.sim.gradient'):
                for source in sim.survey.sources:
                    sim._get_rfield(source, 'f-1')
        assert read({'profile': {'answers': 1}}) == 4
        assert read({'profile': {'answers': 2}}) is None
    finally:
        tracing.clear()
