"""PyTorch port, survey layer without solves, against the JAX package.

On the CPU (``device='cpu'``, JAX in x64), the same inputs made with numpy
from a seed:

- ``edge_curl_factor`` and ``get_magnetic_field`` on a random stretched
  grid with triaxial ``mu_r``: rtol 1e-12 (atol 1e-12 of the largest
  entry);
- ``Survey``, ``DataArray``, the dict helpers and ``from_emg3d_tpu`` for
  a survey and every source and receiver class: identical ``to_dict``
  contents (arrays bit for bit);
- ``io``: a file saved by one package loads in the other as the same
  objects (``.h5``, ``.npz``, ``.json``);
- seeded noise is repeatable, unseeded noise is not;
- the package imports without ``jax``, ``h5py``, ``tqdm`` and ``xarray``,
  ``chip_smoke.py`` names neither ``jax`` nor ``emg3d_tpu``, and the
  public names of this slice are exported.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu import electrodes, fields, surveys
from emg3d_tpu.ops import operator
from emg3d_tpu_torch import electrodes as t_electrodes
from emg3d_tpu_torch import fields as t_fields
from emg3d_tpu_torch import surveys as t_surveys
from emg3d_tpu_torch.convert import from_emg3d_tpu
from emg3d_tpu_torch.ops import operator as t_operator

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = {'jax': (e3, surveys, electrodes),
            'torch': (t3, t_surveys, t_electrodes)}


def same(a, b, path=''):
    """Recursively identical: dict keys, arrays bit for bit (NaN == NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for key in a:
            same(a[key], b[key], f'{path}/{key}')
    elif isinstance(a, (np.ndarray, list, tuple)) or np.isscalar(a):
        assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b, path


def _grid_model_field(seed=11):
    rng = np.random.default_rng(seed)
    h = [rng.uniform(40, 120, n) for n in (7, 9, 6)]
    grid = e3.TensorMesh(h, origin=(-300., -400., -250.))
    shape = grid.shape_cells
    model = e3.Model(grid, property_x=rng.uniform(1, 3, shape),
                     property_y=rng.uniform(1, 4, shape),
                     property_z=rng.uniform(2, 6, shape),
                     mu_r=rng.uniform(1, 2, shape), mapping='Resistivity')
    n = grid.n_edges
    efield = e3.Field(grid, frequency=0.8, data=(
        rng.normal(size=n) + 1j * rng.normal(size=n)))
    return grid, model, efield


def test_edge_curl_factor():
    grid, _, efield = _grid_model_field()
    rng = np.random.default_rng(12)
    zeta = rng.uniform(1e3, 2e3, grid.shape_cells) * (1 + 0.5j)
    ref = operator.edge_curl_factor(
        np.asarray(efield.fx), np.asarray(efield.fy), np.asarray(efield.fz),
        *grid.h, zeta)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    out = t_operator.edge_curl_factor(
        t(efield.fx), t(efield.fy), t(efield.fz), *(t(h) for h in grid.h),
        t(zeta))
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert_allclose(a.numpy(), b, rtol=1e-12,
                        atol=1e-12 * np.abs(b).max())
    # Boundary faces are zero.
    assert not out[0][0].any() and not out[0][-1].any()
    assert not out[1][:, 0].any() and not out[2][:, :, -1].any()


def test_get_magnetic_field():
    grid, model, efield = _grid_model_field()
    ref = fields.get_magnetic_field(model, efield)
    out = t_fields.get_magnetic_field(
        from_emg3d_tpu(model), from_emg3d_tpu(efield), device='cpu')
    assert isinstance(out, t3.Field) and not out.electric
    assert out.frequency == ref.frequency
    assert out.field.dtype == np.complex128
    assert_allclose(out.field, ref.field, rtol=1e-12,
                    atol=1e-12 * np.abs(ref.field).max())
    assert np.abs(ref.field).max() > 0


def test_get_magnetic_field_needs_a_device(monkeypatch):
    """No device means the card: on a host without one it raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    _, model, efield = _grid_model_field()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t3.get_magnetic_field(from_emg3d_tpu(model), from_emg3d_tpu(efield))


def make_survey(pkg, **kwargs):
    _, srv, el = PACKAGES[pkg]
    sources = srv.txrx_coordinates_to_dict(
        el.TxElectricDipole, ([-100., 100.], 0., 0., 0., 0.))
    receivers = srv.txrx_lists_to_dict([
        [el.RxElectricPoint((200., 50., 0., 0., 0.))],
        srv.txrx_coordinates_to_dict(
            el.RxMagneticPoint, ([250., 350.], 0., 100., 90., 0.))])
    return srv.Survey(sources, receivers, frequencies=[1.0, 2.0], **kwargs)


def _data(seed=21):
    rng = np.random.default_rng(seed)
    return 1e-10 * (rng.normal(size=(2, 3, 2))
                    + 1j * rng.normal(size=(2, 3, 2)))


def test_survey_to_dict_identical():
    kw = dict(data=_data(), noise_floor=1e-15, relative_error=0.05,
              name='rt', info='some info')
    ref, out = make_survey('jax', **kw), make_survey('torch', **kw)
    same(out.to_dict(), ref.to_dict())
    assert repr(out) == repr(ref)
    assert out.shape == ref.shape and out.count == ref.count == 12
    same(out.standard_deviation.data, ref.standard_deviation.data)
    same(out.source_coordinates(), ref.source_coordinates())
    same(out.receiver_coordinates('TxED-2'),
         ref.receiver_coordinates('TxED-2'))
    for a, b in zip(out._irec_types, ref._irec_types):
        assert_array_equal(a, b)


def test_survey_convert_and_copy():
    ref = make_survey('jax', data=_data(), noise_floor=1e-15,
                      relative_error=np.full((2, 3, 2), 0.05))
    out = from_emg3d_tpu(ref)
    assert isinstance(out, t3.Survey)
    assert isinstance(out.sources['TxED-1'], t3.TxElectricDipole)
    same(out.to_dict(), ref.to_dict())
    same(out.copy().to_dict(), ref.to_dict())


def test_survey_select():
    data = _data()
    data[1] = np.nan
    ref, out = (make_survey(p, data=data.copy()) for p in ('jax', 'torch'))
    same(out.select(sources='TxED-1', frequencies=['f-2']).to_dict(),
         ref.select(sources='TxED-1', frequencies=['f-2']).to_dict())
    # Sources without data are removed.
    assert out.select().shape == ref.select().shape == (1, 3, 2)
    assert out.isfinite.sum() == ref.isfinite.sum() == 6
    same(out.finite_data(), ref.finite_data())


def test_survey_add_noise_cuts():
    """What ``add_noise`` prunes does not depend on the noise drawn."""
    data = _data()
    data[0, 0, 0] = 1e-20
    ref, out = (make_survey(p, data=data.copy(), noise_floor=1e-15,
                            relative_error=0.05) for p in ('jax', 'torch'))
    ref.add_noise(min_offset=150.0)
    out.add_noise(min_offset=150.0, rng=3)
    assert_array_equal(np.isnan(out.data.observed.data),
                       np.isnan(ref.data.observed.data))
    assert np.isnan(out.data.observed.data).sum() == 3
    # White noise: the amplitude of what was added is the std.
    std = np.sqrt(1e-30 + (0.05 * np.abs(data)) ** 2)
    keep = np.isfinite(out.data.observed.data)
    assert_allclose(np.abs(out.data.observed.data - data)[keep], std[keep],
                    rtol=1e-10)


@pytest.mark.parametrize('ntype', ['white_noise', 'gaussian_correlated',
                                   'gaussian_uncorrelated'])
def test_random_noise_seeded(ntype):
    std = np.full((4, 5, 6), 2.0)
    a = t_surveys.random_noise(std, ntype=ntype, rng=7)
    b = t_surveys.random_noise(std, ntype=ntype,
                               rng=np.random.default_rng(7))
    assert a.shape == std.shape and np.iscomplexobj(a)
    assert_array_equal(a, b)
    # Without a generator every call draws anew, as in the JAX package.
    c = t_surveys.random_noise(std, ntype=ntype)
    d = t_surveys.random_noise(std, ntype=ntype)
    assert not np.array_equal(c, d) and not np.array_equal(a, c)
    if ntype == 'white_noise':
        assert_allclose(np.abs(a), 2.0)
    # The same draws as the JAX package's arithmetic on them.
    assert_allclose(t_surveys.random_noise(std, 0.5, ntype, rng=7),
                    a + std * (1 + 1j) * 0.5)


@pytest.mark.parametrize('op', [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: b / a, lambda a, b: a ** -2, lambda a, b: abs(-a),
    lambda a, b: a.sel(src=['s2'], freq=['f1']),
    lambda a, b: a.copy(data=b.data * 2),
])
def test_dataarray(op):
    coords = (('s1', 's2'), ('r1', 'r2'), ('f1', 'f2'))
    rng = np.random.default_rng(31)
    x, y = rng.uniform(1, 2, (2, 2, 2, 2))
    res = [op(mod.DataArray(x.copy(), coords), mod.DataArray(y.copy(), coords))
           for mod in (surveys, t_surveys)]
    assert_array_equal(res[1].data, res[0].data)
    assert res[1].coords == res[0].coords
    da = t_surveys.DataArray(x.copy(), coords)
    da.loc['s2', 'r1', 'f2'] = 5.0
    assert da.data[1, 0, 1] == 5.0 and da.loc['s2', :, :].shape == (2, 2)


def test_dict_helpers():
    f = t_surveys.frequencies_to_dict([1.0, 10.0])
    assert f == surveys.frequencies_to_dict([1.0, 10.0])
    with pytest.raises(ValueError, match='non-unique'):
        t_surveys.frequencies_to_dict([1.0, 1.0])
    out = t_surveys.txrx_coordinates_to_dict(
        t_electrodes.TxElectricDipole,
        (np.arange(1, 6) * 2000., 0, 0, 0, 0), strength=100.)
    ref = surveys.txrx_coordinates_to_dict(
        electrodes.TxElectricDipole,
        (np.arange(1, 6) * 2000., 0, 0, 0, 0), strength=100.)
    assert list(out) == list(ref)
    for key in ref:
        same(out[key].to_dict(), ref[key].to_dict())


ELECTRODES = {
    'TxElectricPoint': dict(coordinates=(10., 20., -30., 15., 5.),
                            strength=2.0),
    'TxMagneticPoint': dict(coordinates=(10., 20., -30., 15., 5.)),
    'TxElectricDipole': dict(coordinates=(-50., 50., 0., 10., -10., 5.),
                             strength=3.0),
    'TxMagneticDipole': dict(coordinates=(0., 0., 0., 45., 0.), length=4.),
    'TxElectricWire': dict(coordinates=[[0., 0., 0.], [50., 0., 0.],
                                        [50., 50., 10.]]),
    'RxElectricPoint': dict(coordinates=(100., 0., 0., 0., 0.),
                            relative=True),
    'RxMagneticPoint': dict(coordinates=(100., 0., 0., 90., 0.),
                            relative=False),
}


@pytest.mark.parametrize('name', sorted(ELECTRODES))
def test_convert_electrodes(name):
    ref = getattr(electrodes, name)(**ELECTRODES[name])
    out = from_emg3d_tpu(ref)
    assert type(out) is getattr(t3, name)
    same(out.to_dict(), ref.to_dict())
    assert repr(out) == repr(ref)
    assert_array_equal(out.points, ref.points)


def _objects(pkg):
    """A grid, model, field, survey and an array, made by package ``pkg``."""
    mod = PACKAGES[pkg][0]
    grid, model, efield = _grid_model_field()
    if pkg == 'torch':
        grid, model, efield = (from_emg3d_tpu(x)
                               for x in (grid, model, efield))
    survey = make_survey(pkg, data=_data(), noise_floor=1e-15,
                         relative_error=0.05, name='io')
    return mod, dict(grid=grid, model=model, efield=efield, survey=survey,
                     array=np.arange(6.).reshape(2, 3), number=3.5,
                     text='hello', nothing=None, nested={'a': {'b': 1 + 2j}})


@pytest.mark.parametrize('ext', ['h5', 'npz', 'json'])
@pytest.mark.parametrize('writer,reader', [('jax', 'torch'),
                                           ('torch', 'jax'),
                                           ('torch', 'torch')])
def test_io_across_packages(tmp_path, ext, writer, reader):
    wmod, data = _objects(writer)
    rmod, _ = _objects(reader)
    fname = str(tmp_path / f'data.{ext}')
    info = wmod.save(fname, verb=-1, **data)
    assert fname in info
    out = rmod.load(fname)
    for key, cls in (('grid', 'TensorMesh'), ('model', 'Model'),
                     ('efield', 'Field'), ('survey', 'Survey')):
        assert type(out[key]) is getattr(rmod, cls), key
        same(out[key].to_dict(), data[key].to_dict(), key)
    assert_array_equal(out['array'], data['array'])
    assert out['number'] == 3.5 and out['text'] == 'hello'
    assert out['nothing'] is None and out['nested']['a']['b'] == 1 + 2j


def test_io_convert_and_errors(tmp_path):
    _, data = _objects('torch')
    fname = str(tmp_path / 'grid.npz')
    t3.save(fname, grid=data['grid'])
    out = t3.convert(fname, 'TensorMesh')
    assert out['grid'] == data['grid']
    d = data['grid'].to_dict()
    assert t3.convert(d, 'TensorMesh') == data['grid']
    with pytest.raises(ValueError, match='Unknown extension'):
        t3.save(str(tmp_path / 'x.abc'), a=1)
    with pytest.raises(ValueError, match='Unknown extension'):
        t3.load(str(tmp_path / 'x.abc'))
    loaded, info = t3.load(fname, verb=-1)
    assert 'emg3d_tpu_torch v' in info and 'grid' in loaded


def test_import_without_optional_packages():
    """The package imports with jax, h5py, tqdm and xarray unimportable;
    saving to .h5 then says what it needs, .npz works."""
    code = (
        "import sys\n"
        "for name in ('jax', 'h5py', 'tqdm', 'xarray'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, tempfile, os\n"
        "import emg3d_tpu_torch as t3\n"
        "from emg3d_tpu_torch.parallel import tasks\n"
        "assert tasks.process_map(abs, [-1, 2], desc='x') == [1, 2]\n"
        "grid = t3.TensorMesh([np.ones(4)] * 3, origin=(0, 0, 0))\n"
        "d = tempfile.mkdtemp()\n"
        "t3.save(os.path.join(d, 'g.npz'), grid=grid)\n"
        "assert t3.load(os.path.join(d, 'g.npz'))['grid'] == grid\n"
        "try:\n"
        "    t3.save(os.path.join(d, 'g.h5'), grid=grid)\n"
        "except ImportError as e:\n"
        "    print('h5:', e)\n"
        "bad = [m for m in sys.modules if m.startswith('emg3d_tpu.') or "
        "m == 'emg3d_tpu' or (m.startswith('jax') and sys.modules[m])]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["h5: Saving to '.h5' requires h5py.",
                                       '[]']


def test_chip_smoke_names_no_jax():
    pat = re.compile(r'^\s*(import jax|from jax|import emg3d_tpu\b(?!_)'
                     r'|from emg3d_tpu\b(?!_))', re.M)
    for name in ('chip_smoke.py', 'tools/profile_torch_solve.py'):
        assert not pat.search((ROOT / name).read_text()), name


def test_exports():
    names = ['TxElectricPoint', 'TxMagneticPoint', 'TxElectricDipole',
             'TxMagneticDipole', 'TxElectricWire', 'RxElectricPoint',
             'RxMagneticPoint', 'get_magnetic_field', 'save', 'load',
             'convert', 'construct_mesh', 'Survey', 'Simulation', 'Fourier']
    for name in names:
        assert name in t3.__all__ and callable(getattr(t3, name)), name
    # Everything the JAX package exports, the port exports too.
    assert set(e3.__all__) <= set(t3.__all__)
    assert t3.convert is t3.io.convert
