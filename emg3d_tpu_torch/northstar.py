"""The north-star problems of the port, shared by ``chip_smoke.py`` and
``tools/profile_torch_solve.py``.

Each single-solve builder returns ``(model, sfield)`` for a grid of ``n``
cells a side (n/2 vertically for ``marine_problem``), with the options its
solve uses in ``SOLVE_OPTIONS``:

- ``baseline_problem``: the BASELINE recipe (``bench.py:27-44``): 1 Ohm m
  fullspace, 50 m cells, x-directed dipole at the origin, 1 Hz; plain
  multigrid F-cycles.
- ``triaxial_problem``: north-star configuration 3
  (``tools/bench_northstar.py:89-98``): as BASELINE with rho 1/2/5 Ohm m;
  the solver's default options.
- ``marine_problem``: north-star configuration 2
  (``tools/bench_northstar.py:53-86``): layered marine model, 100 m cells
  laterally, 25 m through the water column and stretched by 1.05 below
  the seafloor, x-dipole 30 m above the seafloor, 1 Hz; semicoarsening
  and line-relaxation F-cycles.

``salt_survey`` is north-star configuration 4 (the problem of
``tools/salt_bench.py:43-124``): a multi-source survey over a salt-class
model, with misfit and adjoint-state gradient, every solve with the
solver's default options.  It returns ``(survey, model, simulation
keywords)``.
"""

import contextlib
import time

import numpy as np

from emg3d_tpu_torch import solver
from emg3d_tpu_torch.electrodes import RxElectricPoint, TxElectricPoint
from emg3d_tpu_torch.fields import get_source_field
from emg3d_tpu_torch.meshes import TensorMesh
from emg3d_tpu_torch.models import Model
from emg3d_tpu_torch.surveys import Survey

__all__ = ["baseline_problem", "triaxial_problem", "marine_problem",
           "salt_mask", "salt_model", "salt_survey", "salt_box",
           "timed_solves", "SOLVE_OPTIONS"]

SOLVE_OPTIONS = {
    "baseline": dict(plain=True, cycle='F'),
    "triaxial": {},
    "marine": dict(sslsolver=False, semicoarsening=True,
                   linerelaxation=True, cycle='F', maxit=90),
}


def _fullspace(n, **properties):
    h = np.full(n, 50.0)
    grid = TensorMesh([h, h, h], origin=(-n * 25.0,) * 3)
    model = Model(grid, **properties)
    sfield = get_source_field(grid, source=(0., 0., 0., 0., 0.),
                              frequency=1.0)
    return model, sfield


def baseline_problem(n):
    return _fullspace(n, property_x=1.0)


def triaxial_problem(n):
    return _fullspace(n, property_x=1.0, property_y=2.0, property_z=5.0)


def marine_problem(n):
    nz = n // 2
    hx = np.full(n, 100.0)
    nwater = nz // 3
    hz_water = np.full(nwater, 25.0)
    hz_sed = 25.0 * 1.05 ** np.arange(1, nz - nwater + 1)
    hz = np.concatenate([hz_sed[::-1], hz_water])
    origin = (-n * 50.0, -n * 50.0, -float(np.sum(hz_sed)))
    grid = TensorMesh([hx, hx, hz], origin=origin)
    zc = grid.cell_centers_z
    rho = np.ones((n, n, nz))
    rho[:, :, zc > 0] = 0.3
    sed = zc <= 0
    rho[:, :, sed] = 1.0 + 0.002 * (-zc[sed])
    ztarget = (zc < -800) & (zc > -1100)
    rho[n // 4:3 * n // 4, n // 4:3 * n // 4, ztarget] = 50.0
    model = Model(grid, property_x=rho)
    sfield = get_source_field(grid, source=(0., 0., 30., 0., 0.),
                              frequency=1.0)
    return model, sfield


def salt_mask(grid):
    """The cells of the salt body: an ellipsoid centred at (0, 0, -2600 m)
    with half-axes 2600, 2100 and 900 m, the last roughened laterally."""
    X, Y, Z = np.meshgrid(grid.cell_centers_x, grid.cell_centers_y,
                          grid.cell_centers_z, indexing="ij")
    rough = 1.0 + 0.25 * np.sin(2.2e-3 * X + 0.7) * np.sin(
        1.7e-3 * Y + 1.9)
    return (X ** 2 / 2600.0 ** 2 + Y ** 2 / 2100.0 ** 2
            + (Z + 2600.0) ** 2 / (900.0 * rough) ** 2) < 1.0


def salt_model(grid, seed=20, salt_scale=1.0):
    """Synthetic salt-class resistivity model on ``grid``.

    Sediments: resistivity increasing with depth (0.5 -> ~2 Ohm m) with
    four smooth lateral perturbations; sea water (0.3 Ohm m) above
    z = 0; a salt body (one value from 30-100 Ohm m, times
    ``salt_scale``) with a rough top.  The random values come from
    ``np.random.default_rng(seed)``.
    """
    rng = np.random.default_rng(seed)
    X, Y, Z = np.meshgrid(grid.cell_centers_x, grid.cell_centers_y,
                          grid.cell_centers_z, indexing="ij")

    res = 0.5 * np.exp(-Z / 2500.0)
    for _ in range(4):
        kx, ky = rng.uniform(0.2e-3, 1e-3, 2)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        res *= 1.0 + 0.2 * np.sin(kx * X + ph1) * np.cos(ky * Y + ph2)

    res[salt_mask(grid)] = salt_scale * rng.uniform(30.0, 100.0)
    res[Z > 0] = 0.3

    return Model(grid, property_x=res, mapping="Resistivity")


def salt_survey(n, nsrc, seed=20):
    """The salt-class multi-source survey on ``n``^3 cells of an 8 km cube.

    ``nsrc`` x-directed point sources along y = 0 at z = -30 m between
    +-3000 m; 24 x-directed electric receivers (12 along x between
    +-3500 m on the lines y = +-500 m, z = -100 m); 1 Hz.  Returns
    ``(survey, model, keywords)`` for ``Simulation(survey, model,
    **keywords)``: the model's own grid, linear receiver interpolation
    (exact gradient) and the default solver to 1e-6.
    """
    h = np.full(n, 8000.0 / n)
    grid = TensorMesh([h, h, h], origin=(-4000.0, -4000.0, -7200.0))
    model = salt_model(grid, seed)
    survey = Survey(
        sources=[TxElectricPoint((x, 0, -30, 0, 0))
                 for x in np.linspace(-3000.0, 3000.0, nsrc)],
        receivers=[RxElectricPoint((x, y, -100, 0, 0))
                   for x in np.linspace(-3500, 3500, 12)
                   for y in (-500.0, 500.0)],
        frequencies=1.0, noise_floor=1e-16, relative_error=0.03)
    keywords = dict(gridding='same', verb=-1,
                    receiver_interpolation='linear',
                    solver_opts={'tol': 1e-6})
    return survey, model, keywords


def salt_box(grid):
    """A model perturbation for ``jvec``: 1 in the box |x|, |y| < 500 m,
    -2900 < z < -2300 m in the middle of the salt body, 0 elsewhere."""
    v = np.zeros(grid.shape_cells)
    v[np.ix_(np.abs(grid.cell_centers_x) < 500.0,
             np.abs(grid.cell_centers_y) < 500.0,
             np.abs(grid.cell_centers_z + 2600.0) < 300.0)] = 1.0
    return v


@contextlib.contextmanager
def timed_solves():
    """Within the block, every ``solver.solve`` (so every task of a
    ``Simulation``) and every batched solve
    (``parallel.batch.solve_batch_fields``, one per grid of a
    ``Simulation(parallel='batch')`` stage) appends its wall seconds to
    the list that is yielded: what of a survey's time is spent inside the
    solver (hierarchies and host copies of the solve included) and what
    outside it (source fields, responses, gradient assembly)."""
    from emg3d_tpu_torch.parallel import batch

    seconds = []

    def timed(inner):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                seconds.append(time.perf_counter() - t0)
        return call

    inner = solver.solve, batch.solve_batch_fields
    solver.solve, batch.solve_batch_fields = (timed(f) for f in inner)
    try:
        yield seconds
    finally:
        solver.solve, batch.solve_batch_fields = inner
