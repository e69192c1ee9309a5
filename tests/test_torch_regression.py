"""PyTorch port against the frozen fixtures of tests/data/regression.npz.

The same plain-multigrid cases as tests/test_regression.py (VTI F/W/V
cycles and the Laplace-domain solve), computed by the port alone
(complex128/float64 on the CPU): same cycle counts, fields to rtol 1e-10.
"""

import os

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from emg3d_tpu_torch import fields, meshes, models, solver

FNAME = os.path.join(os.path.dirname(__file__), 'data', 'regression.npz')


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def data():
    return dict(np.load(FNAME))


def vti_setup():
    hx = np.ones(16) * 200.
    hy = np.ones(16) * 300.
    hz = np.r_[np.ones(8) * 100., np.ones(8) * 200.]
    grid = meshes.TensorMesh([hx, hy, hz], origin=(-1600., -2400., -1200.))
    model = models.Model(grid, property_x=1.5, property_z=3.0,
                         mapping='Resistivity')
    sfield = fields.get_source_field(grid, (0., 0., 0., 0., 0.), 0.77)
    return model, sfield


@pytest.mark.parametrize('cycle', ['F', 'W', 'V'])
def test_vti_cycles(data, cycle):
    model, sfield = vti_setup()
    efield, info = solver.solve(
        model, sfield, plain=True, cycle=cycle, tol=1e-6,
        return_info=True, verb=0)
    assert info['it_mg'] == data[f'vti_{cycle}_it']
    assert_allclose(efield.field, data[f'vti_{cycle}_field'], rtol=1e-10,
                    atol=1e-18)


def test_laplace(data):
    hx = np.ones(16) * 200.
    grid = meshes.TensorMesh([hx, hx, hx], origin=(-1600.,) * 3)
    model = models.Model(grid, property_x=2.0, mapping='Resistivity')
    sfield = fields.get_source_field(grid, (0., 0., 0., 0., 0.), -1.5)
    efield, info = solver.solve(
        model, sfield, plain=True, cycle='F', tol=1e-6, return_info=True,
        verb=0)
    assert info['it_mg'] == data['lap_it']
    assert efield.field.dtype == np.float64
    assert_allclose(efield.field, data['lap_field'], rtol=1e-10,
                    atol=1e-18)
