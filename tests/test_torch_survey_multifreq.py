"""PyTorch port, a multi-frequency survey on per-frequency grids
(``gridding='frequency'``) against the benchmark's plain reference
(``benchmark/reference``), on the CPU.

A small marine model on an inversion mesh: air of 1e8 Ohm m above the
sea surface at z = 0, a 300-m sea and sediments below the seafloor,
every cell below the surface with a seeded random resistivity,
log-uniform in 0.3-1 Ohm m in the sea and 1-100 Ohm m below it.  Two
x-directed electric point sources 50 m above the seafloor, four
receivers 0.1 m above it, two frequencies; each frequency's
computational grid is the program's own choice (a least cell width of
one skin depth in the sea), so the two grids differ in shape and cell
widths.  The solves run at tol 1e-6 with point smoothing in V-cycles.

- Each e-field, on its own frequency's grid and at that frequency, has
  a relative residual ``||s - A e|| / ||s||`` below tol with the
  reference's operator (on the reference's own volume averaging of the
  model) and point source.  A field held against the other frequency's
  operator does not.
- The responses, the reference's linear interpolation of the fields on
  their own grids, and the misfit agree with the program's to 1e-10:
  the same float64 sums in another order.
- ``sim_grids`` counts the grids constructed (one per frequency under
  ``'frequency'``, one under ``'single'``), each in one
  ``emg3d.sim.grid`` span with its ``shape``; ``sim_models`` counts the
  models volume-averaged onto a task's grid (each task of the task
  loop; each grid group of the batch engine; none under ``'same'``).

BLAS and torch run on one thread (the test workers share the cores).
"""

import pathlib
import sys

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu_torch import tracing

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmark.reference import maxwell, sources  # noqa: E402
from benchmark.reference import survey as reference  # noqa: E402

FREQS = [0.5, 2.0]
SOURCES = [(-400.0, 0.0, -250.0, 0.0, 0.0), (400.0, 0.0, -250.0, 0.0, 0.0)]
RECEIVERS = [(x, y, -299.9, 0.0, 0.0) for x in (-600.0, 600.0)
             for y in (-300.0, 300.0)]
SURVEY = dict(relative_error=0.05, noise_floor=1e-15)
GRIDDING = dict(seasurface=0.0, max_buffer=2000.0, min_width_pps=1,
                min_width_limits=[100.0, 400.0], stretching=[1.3, 1.5],
                cell_numbers=[8, 10, 12, 16])
SOLVER = dict(tol=1e-6, linerelaxation=False, semicoarsening=False,
              cycle='V', nu_pre=1, nu_post=1, verb=0)
# The inversion mesh: 200-m cells in x and y, 100-m cells in z from
# -1.2 km to the 400 m of air above the sea surface.
MESH = t3.TensorMesh(
    [np.full(16, 200.0), np.full(16, 200.0), np.full(16, 100.0)],
    origin=(-1600.0, -1600.0, -1200.0))


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _rho():
    rng = np.random.default_rng(20261018)
    z = MESH.cell_centers_z[None, None, :] + np.zeros(MESH.shape_cells)
    sea = 10 ** rng.uniform(np.log10(0.3), 0.0, MESH.shape_cells)
    ground = 10 ** rng.uniform(0.0, 2.0, MESH.shape_cells)
    return np.where(z > 0, 1e8, np.where(z > -300, sea, ground))


def _observed():
    """Seeded data of the responses' order of magnitude."""
    rng = np.random.default_rng(7)
    shape = (len(SOURCES), len(RECEIVERS), len(FREQS))
    return 3e-9 * (rng.standard_normal(shape)
                    + 1j * rng.standard_normal(shape))


def _simulation(gridding='frequency', parallel='task'):
    survey = t3.Survey([t3.TxElectricPoint(s) for s in SOURCES],
                       [t3.RxElectricPoint(r) for r in RECEIVERS], FREQS,
                       data=_observed(), **SURVEY)
    model = t3.Model(MESH, property_x=_rho(), mapping='Resistivity')
    return t3.Simulation(
        survey, model, gridding=gridding,
        gridding_opts=GRIDDING if gridding != 'same' else None,
        parallel=parallel, receiver_interpolation='linear',
        tqdm_opts=False, device='cpu', solver_opts=dict(SOLVER))


def _grown(before):
    after = tracing.counts()
    return {k: after[k] - before[k] for k in ('sim_grids', 'sim_models',
                                              'sim_tasks')}


@pytest.fixture(scope='module')
def computed():
    """A forward evaluation of both sources at both frequencies within
    ``recording()``: (simulation, span log, counter growth)."""
    sim = _simulation()
    tracing.clear()
    before = tracing.counts()
    with tracing.recording():
        sim.compute()
        _ = sim.misfit
    return sim, tracing.spans(), _grown(before)


def _pairs(sim):
    return [(i, j, s, f) for i, s in enumerate(sim.survey.sources)
            for j, f in enumerate(sim.survey.frequencies)]


def _grid(sim, s, f):
    g = sim.get_grid(s, f)
    return maxwell.Grid(g.h, g.origin)


def _residual(grid, rho_mesh, field, row, freq):
    mesh = maxwell.Grid(MESH.h, MESH.origin)
    rho = reference.volume_average(mesh, rho_mesh, grid)
    eta, zeta = maxwell.eta_zeta(grid, (rho,) * 3, freq, 'cpu')
    rhs = sources.point_field(grid, row[:3], sources.orientation(*row[3:]),
                              1.0, freq)
    return maxwell.rel_residual(
        maxwell.to_device(rhs, 'cpu'),
        maxwell.to_device((field.fx, field.fy, field.fz), 'cpu'), eta, zeta,
        tuple(torch.as_tensor(w) for w in grid.h))


def test_grids_differ_per_frequency(computed):
    sim = computed[0]
    grids = [sim.get_grid('TxEP-1', f) for f in sim.survey.frequencies]
    assert grids[0].shape_cells != grids[1].shape_cells
    assert grids[0].h[0].min() > grids[1].h[0].min()
    # The sources share each frequency's grid.
    for f in sim.survey.frequencies:
        assert sim.get_grid('TxEP-2', f) is sim.get_grid('TxEP-1', f)


def test_fields_meet_the_reference_residual(computed):
    sim = computed[0]
    rho = sim.model.property_x
    for i, j, s, f in _pairs(sim):
        assert sim.get_efield_info(s, f)['exit'] == 0
        res = _residual(_grid(sim, s, f), rho, sim.get_efield(s, f),
                        SOURCES[i], FREQS[j])
        assert res < SOLVER['tol'], (s, f, res)
    # A field against the operator of the other frequency (on its own
    # grid) is far from tol.
    s, f = 'TxEP-1', 'f-1'
    wrong = _residual(_grid(sim, s, f), rho, sim.get_efield(s, f),
                      SOURCES[0], FREQS[1])
    assert wrong > 1e3 * SOLVER['tol']


def test_responses_and_misfit(computed):
    sim = computed[0]
    synthetic = np.zeros((len(SOURCES), len(RECEIVERS), len(FREQS)),
                         dtype=complex)
    for i, j, s, f in _pairs(sim):
        e = sim.get_efield(s, f)
        synthetic[i, :, j] = reference.responses(
            _grid(sim, s, f), (e.fx, e.fy, e.fz), RECEIVERS)
    program = np.asarray(sim.data.synthetic)
    assert np.max(np.abs(synthetic - program)) <= 1e-10 * np.max(
        np.abs(synthetic))
    observed = np.asarray(sim.data.observed)
    w = reference.weights(observed, **SURVEY)
    assert sim.misfit == pytest.approx(
        reference.misfit(synthetic, observed, w), rel=1e-10, abs=0)


def test_grid_spans_and_counters(computed):
    sim, spans, grown = computed
    tasks = len(SOURCES) * len(FREQS)
    assert grown == {'sim_grids': len(FREQS), 'sim_models': tasks,
                     'sim_tasks': tasks}
    grids = [s for s in spans if s.name == 'emg3d.sim.grid']
    assert [s.attrs['shape'] for s in grids] == [
        sim.get_grid('TxEP-1', f).shape_cells
        for f in sim.survey.frequencies]
    compute = [s for s in spans if s.name == 'emg3d.sim.compute']
    assert len(compute) == 1 and compute[0].parent is None
    assert {s.root for s in grids} == {compute[0].id}
    assert compute[0].attrs['counts']['sim_grids'] == len(FREQS)
    assert compute[0].attrs['counts']['sim_models'] == tasks


@pytest.mark.parametrize('gridding, parallel, grids, models', [
    ('single', 'task', 1, None),
    ('frequency', 'batch', len(FREQS), len(FREQS)),
    ('same', 'batch', 0, 0),
])
def test_counters_of_other_griddings(gridding, parallel, grids, models):
    # Grids and the batch engine's group models, without a solve.
    sim = _simulation(gridding, parallel)
    tracing.clear()
    before = tracing.counts()
    with tracing.recording():
        for s, f in sim._srcfreq:
            sim.get_grid(s, f)
        if models is not None:
            sim._batch_groups(sim._srcfreq)
    grown = _grown(before)
    assert grown['sim_grids'] == grids
    assert len([s for s in tracing.spans()
                if s.name == 'emg3d.sim.grid']) == grids
    assert grown['sim_models'] == (models or 0)
