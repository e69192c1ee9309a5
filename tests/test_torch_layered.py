"""PyTorch port, the numpy engines and the layered mode, against the JAX
package.

``transforms``, ``layered`` and ``time`` are copies: on the inputs of the
JAX package's own tests (tests/test_layered.py, tests/test_time.py) they
must give identical arrays.  ``parallel.tasks.layered`` and
``Simulation(layered=True)`` give the same responses and the same
finite-difference gradient (identical arrays too: no solver is involved),
and keep the JAX package's error messages.
"""

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_array_equal

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu import layered, time, transforms
from emg3d_tpu.parallel import tasks
from emg3d_tpu_torch import layered as t_layered
from emg3d_tpu_torch import time as t_time
from emg3d_tpu_torch import transforms as t_transforms
from emg3d_tpu_torch.convert import from_emg3d_tpu
from emg3d_tpu_torch.parallel import tasks as t_tasks

MODS = {'transforms': (transforms, t_transforms),
        'layered': (layered, t_layered), 'time': (time, t_time)}

ZETA = 1j * 2 * np.pi * 0.8 * (4e-7 * np.pi)
RECS = np.array([[600., 100., -1200.], [700., 300., -250.],
                 [900., -100., 200.]])
TIME = np.logspace(-1.5, 1.0, 15)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores, and the filter design's least squares otherwise spins in as
    many BLAS threads as there are cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _fdata(mod, fftlog=False):
    req = (mod.required_frequencies_fftlog if fftlog
           else mod.required_frequencies)
    freq = req(TIME)
    return freq, 1.0 / (1 + 2j * np.pi * freq)


# (module, what the call returns given that module): the inputs of the JAX
# package's tests of these modules.
CALLS = {
    'design_filter': ('transforms', lambda m: [
        getattr(m.design_filter(), a) for a in ('base', 'sin', 'cos')]),
    'design_hankel_filter': ('transforms', lambda m: [
        getattr(m.design_hankel_filter(), a) for a in ('base', 'j0', 'j1')]),
    'required_frequencies': ('transforms', lambda m: [
        m.required_frequencies(TIME),
        m.required_frequencies(TIME, pts_per_dec=5)]),
    'required_frequencies_fftlog': ('transforms', lambda m: [
        m.required_frequencies_fftlog(np.logspace(-1.2, 0.8, 12))]),
    'fourier_dlf': ('transforms', lambda m: [
        m.fourier_dlf(_fdata(m)[1], _fdata(m)[0], TIME, signal=s)
        for s in (0, 1, -1)]),
    'fourier_dlf_columns': ('transforms', lambda m: [
        m.fourier_dlf(np.stack([_fdata(m)[1], 2 * _fdata(m)[1]], axis=1),
                      _fdata(m)[0], TIME, signal=0)]),
    'fourier_fftlog': ('transforms', lambda m: [
        m.fourier_fftlog(_fdata(m, True)[1], _fdata(m, True)[0], TIME,
                         signal=s) for s in (0, 1, -1)]),
    'fullspace': ('layered', lambda m: list(m.fields_layered(
        (0., 0., 0., 30., 0.),
        np.array([[800., 100., -150.], [300., -500., 250.]]),
        depth=[], res_h=[2.0], frequency=0.7))),
    'two_halfspaces': ('layered', lambda m: list(m.fields_layered(
        (0., 0., 60., 0., 0.), np.array([[230., 140., 35.]]), [0.],
        [1.0, 0.3], 10.0))),
    'vti_lower_halfspace': ('layered', lambda m: list(m.fields_layered(
        (0., 0., 60., 0., 0.), np.array([[200., 0., 60.]]), [0.],
        [1.0, 0.3], 10.0, aniso=[2.0, 1.0]))),
    'vti_stack': ('layered', lambda m: [
        x for azm, elv in [(0., 0.), (30., 40.), (0., 90.)]
        for x in m.fields_layered((0., 0., -750., azm, elv), RECS,
                                  [-1000., -500., 0.], [2.0] * 4, 0.8,
                                  aniso=[1.7] * 4)]),
    'dipole_layered': ('layered', lambda m: [m.dipole_layered(
        (0., 0., 60., 25., 15.), [(240., 130., 35., -50., 40.)], [0.],
        [1.0, 0.3], 10.0, aniso=[1.6, 2.0], rec_type=rt)
        for rt in ('electric', 'magnetic')]),
    'sommerfeld_table': ('layered', lambda m: list(m._sommerfeld_table(
        np.sqrt(ZETA * 0.5), 400.0, 250.0).values())),
    'vti_fullspace_primary': ('layered', lambda m: list(
        m._vti_fullspace_primary(RECS, np.array([0.6, 0.0, 0.8]), 0.5,
                                 0.5 / 1.7 ** 2, ZETA))),
    'fourier_dlf_class': ('time', lambda m: _fourier(m, 'dlf')),
    'fourier_fftlog_class': ('time', lambda m: _fourier(m, 'fftlog')),
    'fourier_coarse': ('time', lambda m: [
        m.Fourier(np.logspace(-2, 1, 11), 0.01, 10, verb=0,
                  every_x_freq=2).freq_coarse,
        m.Fourier(np.logspace(-2, 1, 11), 0.01, 10, verb=0,
                  input_freq=np.array([0.1, 1.0, 5.0])).freq_compute]),
}


def _fourier(mod, ft):
    f = mod.Fourier(np.logspace(-2, 1, 11), 0.05, 5, signal=1, ft=ft,
                    verb=0)
    rng = np.random.default_rng(7)
    fdata = (rng.random(f.freq_compute.size)
             + 1j * rng.random(f.freq_compute.size))
    return [f.freq_required, f.freq_compute, f.ifreq_interpolate,
            f.ifreq_extrapolate, f.interpolate(fdata),
            f.freq2time(fdata, 900.0)]


@pytest.mark.parametrize('name', sorted(CALLS))
def test_identical_arrays(name):
    key, call = CALLS[name]
    ref, out = (call(mod) for mod in MODS[key])
    assert len(out) == len(ref) > 0
    for a, b in zip(out, ref):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert_array_equal(a, b)
        assert np.all(np.isfinite(a))


def test_fourier_messages():
    f = t3.Fourier(np.logspace(-2, 1, 11), fmin=0.01, fmax=10, verb=0)
    assert repr(f) == repr(e3.Fourier(np.logspace(-2, 1, 11), fmin=0.01,
                                      fmax=10, verb=0))
    with pytest.raises(TypeError, match='Unexpected '):
        t3.Fourier(np.logspace(-2, 1, 11), 0.01, 10, nonsense=1)
    with pytest.raises(ValueError, match='fftlog'):
        t3.Fourier(np.logspace(-2, 1, 11), 0.01, 10, ft='nonsense', verb=0)
    with pytest.raises(ValueError, match='signal'):
        t_transforms.fourier_dlf(*_fdata(t_transforms)[::-1], TIME,
                                 signal=2)


def make_sim(mod, vti=False, **kwargs):
    """The layered simulation of tests/test_simulations.py (16^3 cells of
    100 m, one source, two receivers), here with a z-dependent model."""
    h = np.ones(16) * 100.0
    grid = mod.TensorMesh([h, h, h], origin=(-800.,) * 3)
    rho = np.ones((16, 16, 16))
    rho[:, :, :6] = 3.0
    props = dict(property_z=2 * rho) if vti else {}
    model = mod.Model(grid, property_x=rho, mapping='Resistivity', **props)
    src = mod.TxElectricDipole((0., 0., 0., 0., 0.))
    recs = [mod.RxElectricPoint((x, 60., 0., 0., 0.)) for x in (300., 400.)]
    survey = mod.Survey([src], recs, [1.0, 3.0], relative_error=0.05)
    if mod is t3:
        kwargs['device'] = 'cpu'
    return mod.Simulation(
        survey=survey, model=model, gridding='same', layered=True,
        tqdm_opts=False, receiver_interpolation='linear', **kwargs)


@pytest.mark.parametrize('vti', [False, True])
def test_simulation_layered(vti):
    ref, out = make_sim(e3, vti), make_sim(t3, vti)
    assert out.layered_opts == ref.layered_opts
    assert out.layered_opts['method'] == 'cylinder'
    for sim in (ref, out):
        sim.compute(observed=True, add_noise=False)
        sim.data['observed'] = sim.data.observed * 1.1
    syn = np.asarray(out.data.synthetic)
    assert np.all(np.isfinite(syn)) and np.abs(syn).max() > 0
    assert_array_equal(syn, np.asarray(ref.data.synthetic))
    assert out.misfit == ref.misfit > 0
    grad = out.gradient
    assert grad.shape == ((2, 16, 16, 16) if vti else (16, 16, 16))
    assert np.abs(grad).max() > 0
    assert_array_equal(grad, ref.gradient)


@pytest.mark.parametrize('method', ['midpoint', 'source', 'receiver'])
def test_tasks_layered(method):
    ref = make_sim(e3, layered_opts={'method': method})
    out = from_emg3d_tpu(ref, device='cpu')
    assert out.layered and out.layered_opts == ref.layered_opts

    def task(sim):
        return {'model': sim.model, 'src': sim.survey.sources['TxED-1'],
                'receivers': sim.survey.receivers,
                'frequencies': sim.survey.frequencies,
                'layered_opts': sim.layered_opts, 'gradient': False,
                'observed': None}

    a, b = t_tasks.layered(task(out)), tasks.layered(task(ref))
    assert a.shape == (2, 2) and np.all(np.isfinite(a))
    assert_array_equal(a, b)
    assert t_tasks._get_points(method, *_ends(out)) == tasks._get_points(
        method, *_ends(ref))


def _ends(sim):
    return sim.survey.sources['TxED-1'], sim.survey.receivers['RxEP-2']


def test_layered_raises():
    sim = make_sim(t3)
    with pytest.raises(NotImplementedError, match='layered'):
        sim.compute(source='TxED-1', frequency='f-1')
    with pytest.raises(NotImplementedError, match='jvec'):
        sim.jvec(np.ones((16, 16, 16)))
    h = np.ones(16) * 100.0
    grid = t3.TensorMesh([h, h, h], origin=(-800.,) * 3)
    model = t3.Model(grid, property_x=1.0, property_y=2.0, property_z=3.0)
    survey = t3.Survey([t3.TxElectricDipole((0., 0., 0., 0., 0.))],
                       [t3.RxElectricPoint((300., 0., 0., 0., 0.))], [1.0],
                       relative_error=0.05)
    with pytest.raises(NotImplementedError, match='triaxial'):
        t3.Simulation(survey=survey, model=model, gridding='same',
                      layered=True, tqdm_opts=False, device='cpu')
    wire = t3.Survey([t3.TxElectricWire([[0., 0., 0.], [50., 0., 0.],
                                         [50., 50., 0.]])],
                     [t3.RxElectricPoint((300., 0., 0., 0., 0.))], [1.0])
    with pytest.raises(ValueError, match='Only Points and Dipoles'):
        t3.Simulation(survey=wire, model=sim.model, gridding='same',
                      layered=True, tqdm_opts=False, device='cpu')
