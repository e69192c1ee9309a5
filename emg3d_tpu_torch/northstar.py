"""The north-star problems of the port, shared by ``chip_smoke.py`` and
``tools/profile_torch_solve.py``.

Each builder returns ``(model, sfield)`` for a grid of ``n`` cells a side
(n/2 vertically for ``marine_problem``), with the options its solve uses
in ``SOLVE_OPTIONS``:

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
"""

import numpy as np

from emg3d_tpu_torch.fields import get_source_field
from emg3d_tpu_torch.meshes import TensorMesh
from emg3d_tpu_torch.models import Model

__all__ = ["baseline_problem", "triaxial_problem", "marine_problem",
           "SOLVE_OPTIONS"]

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
