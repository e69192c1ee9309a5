"""PyTorch port, host layer: meshes, models, sources and receivers.

The port's numpy-only host modules are copies of the JAX package's; the
port's objects are made from the JAX package's by
``emg3d_tpu_torch.convert.from_emg3d_tpu``, and both packages must give
identical arrays.  The port must import without JAX.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_array_equal

import emg3d_tpu_torch as e3t
from emg3d_tpu import fields, meshes, models
from emg3d_tpu_torch import convert
from emg3d_tpu_torch import fields as t_fields
from emg3d_tpu_torch import models as t_models

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _grid():
    rng = np.random.default_rng(3)
    h = [rng.uniform(40, 120, n) for n in (10, 8, 6)]
    return meshes.TensorMesh(h, origin=(-400., -300., -250.))


def _model(grid):
    rng = np.random.default_rng(4)
    shape = grid.shape_cells
    return models.Model(grid, property_x=rng.uniform(1, 3, shape),
                        property_z=rng.uniform(2, 6, shape),
                        mapping='Resistivity')


def test_mesh_and_model_convert():
    grid = _grid()
    tgrid = convert.from_emg3d_tpu(grid)
    assert isinstance(tgrid, e3t.TensorMesh)
    for name in ('nodes_x', 'nodes_y', 'nodes_z', 'cell_centers_x',
                 'cell_centers_z', 'cell_volumes'):
        assert_array_equal(getattr(tgrid, name), getattr(grid, name))
    assert tgrid.shape_cells == grid.shape_cells

    model = _model(grid)
    tmodel = convert.from_emg3d_tpu(model)
    assert isinstance(tmodel, e3t.Model)
    assert tmodel.case == model.case == 'VTI'
    assert_array_equal(tmodel.property_x, model.property_x)
    assert_array_equal(tmodel.property_z, model.property_z)


@pytest.mark.parametrize('frequency', [0.77, -1.5])
def test_volume_model_and_source(frequency):
    grid = _grid()
    model = _model(grid)
    src = (10., -20., 5., 30., 15.)
    sfield = fields.get_source_field(grid, src, frequency)
    tsfield = t_fields.get_source_field(convert.from_emg3d_tpu(grid), src,
                                        frequency)
    assert tsfield.field.dtype == sfield.field.dtype
    assert_array_equal(tsfield.field, sfield.field)

    vm = models.VolumeModel(model, sfield)
    tvm = t_models.VolumeModel(convert.from_emg3d_tpu(model), tsfield)
    for name in ('eta_x', 'eta_y', 'eta_z', 'zeta'):
        assert_array_equal(getattr(tvm, name), getattr(vm, name))


def test_field_convert_and_receiver():
    grid = _grid()
    rng = np.random.default_rng(5)
    n = grid.n_edges
    field = fields.Field(grid, data=rng.normal(size=n) + 1j * rng.normal(
        size=n), frequency=1.0)
    tfield = convert.from_emg3d_tpu(field)
    assert isinstance(tfield, e3t.Field)
    assert_array_equal(tfield.field, field.field)
    assert_array_equal(tfield.fy, field.fy)
    rec = ([-100., 0., 120.], [10., -30., 0.], [0., 20., -40.], 15., 5.)
    assert_array_equal(e3t.get_receiver(tfield, rec),
                       fields.get_receiver(field, rec))

    with pytest.raises(TypeError):
        convert.from_emg3d_tpu(models.VolumeModel(_model(grid), field))


def test_import_leaves_jax_out():
    code = ("import sys, emg3d_tpu_torch, emg3d_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'emg3d_tpu.')) or m == 'emg3d_tpu']; "
            "print(bad)")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == '[]'


def test_sources_name_no_jax():
    pat = re.compile(r'^\s*(import jax|from jax|import emg3d_tpu\b(?!_)'
                     r'|from emg3d_tpu\b(?!_))', re.M)
    files = sorted((ROOT / 'emg3d_tpu_torch').rglob('*.py'))
    assert files
    for path in files:
        assert not pat.search(path.read_text()), path
