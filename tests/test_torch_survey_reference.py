"""PyTorch port, the survey layer against the benchmark's plain reference
(``benchmark/reference/survey.py``), on the CPU.

A seeded random model, log-uniform in 0.3-100 Ohm m, on an inversion
mesh of 16^3 cells, and a stretched computational grid of 8^3 cells
(``gridding='input'``) whose cells the mesh splits along every axis:
some mesh cells are exactly one computational cell, others a half or a
third of one, and the mesh reaches past the grid on one side and stops
short of it on the other (the model is then extrapolated).  Electric
point sources and receivers, linear receiver interpolation, 1 Hz.

- (a) The program's responses, misfit and gradient against the
  reference fed the program's fields, to 1e-10: the same float64 sums in
  another order.
- (b) The reference's adjoint source against the program's
  ``Simulation._get_rfield``, to 1e-14 of its largest entry: the same
  products, summed receiver by receiver in the same order.
- (c) The reference's gradient against central finite differences of the
  program's misfit, with solves at tol 1e-10, in 3 mesh cells that are
  one computational cell each (there the log10 volume averaging of the
  model and the linear transpose of the gradient agree, so the gradient
  is the misfit's derivative): to 1e-5 relative, the finite difference's
  step error (relative step 1e-3) and the solves' residual.
- (d) A recorded iterate logs every span of the survey layer under one
  ``emg3d.sim.gradient`` root; ``tracing.roots()`` lists its 4 solves,
  each with its counts; ``rfield_receivers`` grows by sources x receivers
  and ``sim_tasks`` by 4.  ``tools.profile_torch_solve.host_stage``, as
  ``chip_smoke.py``'s ``[survey]`` phase, counts the 4 solves and the
  seconds inside them.
- (e) ``Simulation.get_bfield`` returns the fields the gradient is
  assembled from, and on a fresh simulation computes them.

BLAS and torch run on one thread (the test workers share the cores).
"""

import contextlib
import io
import pathlib
import re
import sys

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu_torch import tracing

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmark.reference import maxwell  # noqa: E402
from benchmark.reference import survey as reference  # noqa: E402

FREQ = 1.0
SOURCES = [(-60.0, 15.0, 20.0, 0.0, 0.0), (70.0, -25.0, -10.0, 0.0, 0.0)]
RECEIVERS = [(x, y, -40.0, 0.0, 0.0) for x in (-160.0, 150.0)
             for y in (-130.0, 140.0)]
SURVEY = dict(relative_error=0.05, noise_floor=1e-15)
SPANS = {'emg3d.sim.compute', 'emg3d.sim.responses', 'emg3d.sim.misfit',
         'emg3d.sim.rfield', 'emg3d.sim.bcompute', 'emg3d.sim.gradient',
         'emg3d.sim.gradient.assemble', 'emg3d.sim.model'}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _split(widths, parts):
    """Each cell of ``widths`` in ``parts[i]`` equal pieces."""
    return np.concatenate([np.full(p, w / p) for w, p in zip(widths, parts)])


# The computational grid: 8 stretched cells a side, centred on 0.
WIDTHS = np.array([160.0, 120.0, 100.0, 100.0, 100.0, 100.0, 120.0, 160.0])
GRID = t3.TensorMesh([WIDTHS] * 3, origin=(-480.0,) * 3)
# The mesh: the grid's cells in 1, 2 or 3 pieces; the first piece of the
# first cell left out (the grid reaches past the mesh) and one cell of
# 200 m added after the last (the mesh reaches past the grid).
PARTS = [3, 2, 1, 2, 1, 2, 2, 3]
MESH_H = np.r_[_split(WIDTHS, PARTS)[1:], 200.0]
MESH = t3.TensorMesh([MESH_H] * 3, origin=(-480.0 + 160.0 / 3,) * 3)
# Mesh cells that are one grid cell (the unsplit cells 2 and 4 of the
# grid, along every axis).
WHOLE = [int(sum(PARTS[:i])) - 1 for i in (2, 4)]


def _rho():
    rng = np.random.default_rng(20261018)
    return 10 ** rng.uniform(np.log10(0.3), 2.0, MESH.shape_cells)


def _simulation(rho, sources, observed=None, tol=1e-6):
    survey = t3.Survey([t3.TxElectricPoint(s) for s in sources],
                       [t3.RxElectricPoint(r) for r in RECEIVERS], [FREQ],
                       data=observed, **SURVEY)
    model = t3.Model(MESH, property_x=rho, mapping='Resistivity')
    return t3.Simulation(
        survey, model, gridding='input', gridding_opts=GRID,
        receiver_interpolation='linear', tqdm_opts=False, device='cpu',
        solver_opts={'tol': tol, 'linerelaxation': False,
                     'semicoarsening': False, 'cycle': 'V', 'nu_pre': 1,
                     'nu_post': 1, 'verb': 0})


def _observed(rho, sources, tol):
    """Observed data: the program's responses of ``rho`` times 1.5."""
    sim = _simulation(1.5 * rho, sources, tol=tol)
    sim.compute(observed=True, add_noise=False)
    return np.asarray(sim.data.observed)


def _fields(sim, getter):
    return [(f.fx, f.fy, f.fz) for f in
            (getter(s, 'f-1') for s in sim.survey.sources)]


def _grid(sim):
    g = sim.get_grid('TxEP-1', 'f-1')
    return maxwell.Grid(g.h, g.origin)


@pytest.fixture(scope='module')
def iterate():
    """One recorded iterate of two sources: (simulation, span log, solve
    roots, counter growth, what host_stage printed)."""
    from tools import profile_torch_solve

    rho = _rho()
    sim = _simulation(rho, SOURCES, _observed(rho, SOURCES, 1e-6))
    before = tracing.counts()
    out = io.StringIO()
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda: None       # host_stage syncs the card
    try:
        with contextlib.redirect_stdout(out):
            profile_torch_solve.host_stage(
                "survey iterate", 4, lambda: sim.gradient)
    finally:
        torch.cuda.synchronize = sync
    after = tracing.counts()
    grown = {k: after[k] - before[k] for k in after}
    return sim, tracing.spans(), tracing.roots(), grown, out.getvalue()


def test_a_responses_misfit_gradient(iterate):
    sim = iterate[0]
    grid, mesh = _grid(sim), maxwell.Grid(MESH.h, MESH.origin)
    efields = _fields(sim, sim.get_efield)
    synthetic = np.array([reference.responses(grid, e, RECEIVERS)
                          for e in efields])
    program = np.asarray(sim.data.synthetic)[:, :, 0]
    assert np.max(np.abs(synthetic - program)) <= 1e-10 * np.max(
        np.abs(synthetic))
    observed = np.asarray(sim.data.observed)[:, :, 0]
    w = reference.weights(observed, **SURVEY)
    np.testing.assert_allclose(np.asarray(sim.data.weights)[:, :, 0], w,
                               rtol=1e-12)
    assert sim.misfit == pytest.approx(
        reference.misfit(synthetic, observed, w), rel=1e-10, abs=0)
    g = reference.gradient(grid, mesh, sim.model.property_x, efields,
                           _fields(sim, sim.get_bfield), FREQ)
    assert np.max(np.abs(sim.gradient - g)) <= 1e-10 * np.max(np.abs(g))
    # The model on the grid is the reference's averaging of the mesh's.
    np.testing.assert_allclose(
        sim.get_model('TxEP-1', 'f-1').property_x,
        reference.volume_average(mesh, sim.model.property_x, grid),
        rtol=1e-12)


def test_b_adjoint_source(iterate):
    sim = iterate[0]
    grid = _grid(sim)
    residual = np.asarray(sim.data.residual)[:, :, 0]
    weight = np.asarray(sim.data.weights)[:, :, 0]
    for k, src in enumerate(sim.survey.sources):
        program = sim._get_rfield(src, 'f-1')
        ref = reference.adjoint_source(grid, RECEIVERS, residual[k],
                                       weight[k], FREQ)
        scale = np.max(np.abs(program.field))
        for a, b in zip(ref, (program.fx, program.fy, program.fz)):
            assert np.max(np.abs(a - b)) <= 1e-14 * scale


@pytest.fixture(scope='module')
def one_source():
    """A simulation of the first source at tol 1e-10 whose adjoint
    fields ``get_bfield`` computed first: (simulation, solves it
    dispatched then, the reference's gradient from its fields)."""
    rho = _rho()
    sources = SOURCES[:1]
    sim = _simulation(rho, sources, _observed(rho, sources, 1e-10),
                      tol=1e-10)
    before = tracing.counts()['sim_tasks']
    bfields = _fields(sim, sim.get_bfield)
    tasks = tracing.counts()['sim_tasks'] - before
    grid, mesh = _grid(sim), maxwell.Grid(MESH.h, MESH.origin)
    ref = reference.gradient(grid, mesh, rho, _fields(sim, sim.get_efield),
                             bfields, FREQ)
    return sim, tasks, ref


def test_c_gradient_against_finite_differences(one_source):
    sim, _, ref = one_source
    rho, sources = sim.model.property_x, SOURCES[:1]
    observed = np.asarray(sim.data.observed)
    # The three cells of largest gradient among those that are one grid
    # cell each.
    whole = [(i, j, k) for i in WHOLE for j in WHOLE for k in WHOLE]
    cells = sorted(whole, key=lambda c: -abs(ref[c]))[:3]
    for cell in cells:
        step = 1e-3 * rho[cell]
        misfits = []
        for sign in (1, -1):
            pert = rho.copy()
            pert[cell] += sign * step
            misfits.append(_simulation(pert, sources, observed,
                                       tol=1e-10).misfit)
        fd = (misfits[0] - misfits[1]) / (2 * step)
        assert fd == pytest.approx(ref[cell], rel=1e-5), cell


def test_d_recorded_iterate(iterate):
    sim, spans, solves, grown, printed = iterate
    assert SPANS <= {s.name for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == 'emg3d.sim.gradient'
    assert {s.root for s in spans} == {root.id}
    assert [s.name for s in solves] == ['emg3d.solve'] * 4
    assert all(s.attrs['counts']['host_syncs'] > 0 for s in solves)
    nrec = len(RECEIVERS) * len(SOURCES)
    assert grown['rfield_receivers'] == nrec
    assert root.attrs['counts']['rfield_receivers'] == nrec
    assert grown['sim_tasks'] == root.attrs['counts']['sim_tasks'] == 4
    assert [s.attrs['receivers'] for s in spans
            if s.name == 'emg3d.sim.rfield'] == [len(RECEIVERS)] * 2
    # The tool reads the 4 solves and the seconds inside them.
    inside = sum(s.seconds for s in solves)
    found = re.search(r"for (\d+) solves \(expected 4\), (\S+) s inside",
                      printed)
    assert found and int(found[1]) == 4, printed
    assert float(found[2]) == pytest.approx(inside, rel=1e-12)
    assert 0 < inside < root.seconds


def test_e_get_bfield(iterate, one_source):
    # On a fresh simulation get_bfield computes the forward and adjoint
    # solves; the gradient is then assembled from these fields, with no
    # further solve, and equals the reference's from them.
    sim, tasks, ref = one_source
    assert tasks == 2
    before = tracing.counts()['sim_tasks']
    grad = sim.gradient
    assert tracing.counts()['sim_tasks'] == before
    assert np.max(np.abs(grad - ref)) <= 1e-10 * np.max(np.abs(ref))
    assert sim.get_bfield_info('TxEP-1', 'f-1')['exit'] == 0
    # After the gradient, it returns the fields the gradient used.
    sim = iterate[0]
    for src in sim.survey.sources:
        assert sim.get_bfield(src, 'f-1') is sim._dict_bfield[src]['f-1']


def test_working_precision_of_a_model_with_air():
    # Air of 1e8 Ohm m over sea water: |eta| of an air cell is 1e-9 of
    # its curl-curl terms, which float32 rounds away; the multigrid then
    # diverges (here forced to complex64 on the CPU).  By default the card
    # runs such a model's multigrid in double precision
    # (config.SINGLE_MIN_ETA_RATIO); a fullspace of 1-5 Ohm m stays in
    # single precision.
    from emg3d_tpu_torch import config, models

    h = np.array([2000., 1000., 500., 250., 100., 100., 100., 100., 250.,
                  500., 1000., 2000.])
    hz = np.array([1000., 500., 200., 100., 100., 100., 100., 100., 200.,
                   500., 1000., 2000.])
    grid = t3.TensorMesh([h, h, hz], origin=(-3900., -3900., -2200.))
    z = grid.cell_centers_z
    rho = np.ones(grid.shape_cells) * np.where(
        z > 0, 1e8, np.where(z > -200, 0.3, 1.0))
    model = t3.Model(grid, property_x=rho, mapping='Resistivity')
    sfield = t3.get_source_field(grid, t3.TxElectricPoint(
        (0., 0., -150., 0., 0.)), 1.0)
    ratio = models.VolumeModel(model, sfield).min_eta_ratio
    # |s mu_0| 1e-8 S/m (100 m)^2.
    assert ratio == pytest.approx(2 * np.pi * 4e-7 * np.pi * 1e-8 * 1e4,
                                  rel=1e-6)
    card = torch.device('cuda')
    assert config.working_dtypes(card, True, None, ratio) == (
        torch.complex128, torch.float64)
    assert config.working_dtypes(card, True, 'complex64', ratio) == (
        torch.complex64, torch.float32)
    fullspace = t3.Model(grid, property_x=1.0, property_z=5.0,
                         mapping='Resistivity')
    assert config.working_dtypes(card, True, None, models.VolumeModel(
        fullspace, sfield).min_eta_ratio) == (torch.complex64,
                                              torch.float32)

    opts = dict(device='cpu', tol=1e-6, return_info=True, maxit=50,
                linerelaxation=False, cycle='V', nu_pre=1, nu_post=1)
    assert t3.solve(model, sfield, **opts)[1]['exit'] == 0
    assert t3.solve(model, sfield, dtype='complex64', **opts)[1][
        'exit_message'].startswith('DIVERGED')
