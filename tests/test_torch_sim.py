"""PyTorch port, ``Simulation`` against ``emg3d_tpu.Simulation``.

Both packages run the same survey in complex128 on the CPU (JAX in x64,
the port with ``device='cpu'``): 2 sources x 2 frequencies, two electric
and one magnetic receiver, a VTI model with a random perturbation on a
grid of 8^3 cells of 200 m (the JAX package compiles its solver for each
shape, so one small shape serves the whole file), plain multigrid F-cycles (the default solver is held in
tests/test_torch_sim_grad.py).  The JAX simulation is built once for the
module.  Tolerances: synthetic data, misfit and gradient rtol 1e-8 (atol
1e-8 of the largest entry), ``jvec`` and ``jtvec`` rtol 1e-7, the same
``it_mg`` per task.  Every gridding mode gives the same grids (``h`` and
``origin`` identical); ``file_dir`` gives the same data as in memory;
dicts and files carry the simulation, its device and its dtype
(``parallel='batch'`` is held in tests/test_torch_sim_batch.py).
"""

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_allclose, assert_array_equal

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu_torch.convert import from_emg3d_tpu

N = 8       # cells a side of the solved grids
SRCFREQ = [(s, f) for s in ('TxED-1', 'TxED-2') for f in ('f-1', 'f-2')]


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def make_inputs(mod, nx=8, seed=41):
    """A small survey and model made by package ``mod`` from a seed: a
    cube of 1600 m a side in ``nx``^3 cells."""
    rng = np.random.default_rng(seed)
    h = np.ones(nx) * 1600.0 / nx
    grid = mod.TensorMesh([h, h, h], origin=(-800.,) * 3)
    shape = grid.shape_cells
    model = mod.Model(grid, property_x=rng.uniform(0.8, 1.2, shape),
                      property_z=rng.uniform(1.5, 2.5, shape),
                      mapping='Resistivity')
    sources = [mod.TxElectricDipole((x, 0., 0., 0., 0.))
               for x in (-100., 100.)]
    receivers = [mod.RxElectricPoint((x, 50., 0., 0., 0.))
                 for x in (250., 350.)]
    receivers += [mod.RxMagneticPoint((300., 0., 100., 90., 0.))]
    survey = mod.Survey(sources, receivers, [1.0, 2.0],
                        relative_error=0.05, noise_floor=1e-17)
    sim_inp = {
        'survey': survey, 'gridding': 'same',
        'receiver_interpolation': 'linear', 'tqdm_opts': False,
        'solver_opts': {'plain': True, 'tol': 5e-7, 'verb': 0},
    }
    if mod is t3:
        sim_inp['device'] = 'cpu'
    return model, sim_inp


def observed_data(mod):
    """Observed data: the responses of the model scaled by 1.2."""
    model, sim_inp = make_inputs(mod)
    true = mod.Model(model.grid, property_x=1.2 * model.property_x,
                     property_z=1.2 * model.property_z,
                     mapping='Resistivity')
    sim = mod.Simulation(model=true, **sim_inp)
    sim.compute(observed=True, add_noise=False)
    return np.asarray(sim.data.observed).copy()


def close(a, b, rtol=1e-8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.fixture(scope='module')
def pair():
    """(JAX simulation, the port's) on the same survey with observed data,
    misfit and gradient computed."""
    sims = []
    for mod in (e3, t3):
        model, sim_inp = make_inputs(mod)
        sim_inp['survey'].data['observed'] = observed_data(mod)
        sim = mod.Simulation(model=model, name='pair', **sim_inp)
        _ = sim.gradient
        sims.append(sim)
    return sims


def test_observed(pair):
    ref, out = pair
    close(out.data.observed, ref.data.observed)
    assert np.all(np.isfinite(np.asarray(out.data.observed)))


def test_synthetic(pair):
    ref, out = pair
    close(out.data.synthetic, ref.data.synthetic)
    close(out.data.residual, ref.data.residual)
    same = np.asarray(out.survey.standard_deviation)
    close(same, ref.survey.standard_deviation)
    # Electric and magnetic receivers both responded.
    assert np.all(np.abs(np.asarray(out.data.synthetic)) > 0)


def test_misfit(pair):
    ref, out = pair
    assert out.misfit > 0
    assert_allclose(out.misfit, ref.misfit, rtol=1e-8)


def test_gradient(pair):
    ref, out = pair
    assert out.gradient.shape == (2, N, N, N)
    close(out.gradient, ref.gradient)
    assert np.abs(out.gradient).max() > 0


@pytest.mark.parametrize('src,freq', SRCFREQ)
def test_task_info_and_fields(pair, src, freq):
    ref, out = pair
    for which in ('efield', 'bfield'):
        a = out._dict_get(f'{which}_info', src, freq)
        b = ref._dict_get(f'{which}_info', src, freq)
        assert a['it_mg'] == b['it_mg'] > 0
        assert a['it_ssl'] == b['it_ssl'] == 0
        assert a['exit'] == b['exit'] == 0
        close(out._dict_get(which, src, freq).field,
              ref._dict_get(which, src, freq).field)
    close(out.get_hfield(src, freq).field, ref.get_hfield(src, freq).field,
          rtol=1e-8)
    assert out.get_efield_info(src, freq)['exit_message'] == 'CONVERGED'


def test_jvec(pair):
    ref, out = pair
    v = np.random.default_rng(42).normal(size=(2, N, N, N))
    a, b = out.jvec(v), ref.jvec(v)
    assert np.all(np.isfinite(a)) and np.abs(a).max() > 0
    close(a, b, rtol=1e-7)


def test_jtvec(pair):
    # On copies: jtvec replaces the residual and the gradient.
    ref, out = (sim.copy() for sim in pair)
    rng = np.random.default_rng(43)
    w = rng.normal(size=out.survey.shape) * np.asarray(out.data.weights)
    a, b = out.jtvec(w), ref.jtvec(w)
    assert a.shape == (2, N, N, N)
    close(a, b, rtol=1e-7)


def test_accessors_and_info(pair):
    ref, out = pair
    assert repr(out) == repr(ref)
    assert out.print_grid_info(return_info=True) == ref.print_grid_info(
        return_info=True)
    info = out.print_solver_info('efield', verb=1, return_info=True)
    assert info == ref.print_solver_info('efield', verb=1, return_info=True)
    assert info.count('CONVERGED') == 4
    assert out.get_grid('TxED-1', 1.0) is out.model.grid
    assert out.get_model('TxED-2', 'f-2') is out.model
    assert out.device == 'cpu' and out.solver_opts['device'] == 'cpu'


def test_dict_and_copy(pair):
    ref, out = pair
    d = out.to_dict(what='all', copy=True)
    assert d['device'] == 'cpu'
    assert set(ref.to_dict(what='all')) | {'device'} == set(d)
    back = t3.Simulation.from_dict(d)
    assert back._computed and back.device == 'cpu' and back.name == 'pair'
    assert_array_equal(np.asarray(back.data.synthetic),
                       np.asarray(out.data.synthetic))
    assert_array_equal(back.gradient, out.gradient)
    assert back.misfit == out.misfit
    assert_array_equal(back._dict_get('bfield', 'TxED-2', 'f-1').field,
                       out._dict_get('bfield', 'TxED-2', 'f-1').field)
    cp = out.copy()
    assert cp.survey is not out.survey
    assert_array_equal(cp.get_efield('TxED-1', 'f-2').field,
                       out.get_efield('TxED-1', 'f-2').field)
    with pytest.raises(TypeError, match='Unrecognized'):
        out.to_dict(what='nonsense')


def test_from_emg3d_tpu_simulation(pair, monkeypatch):
    """A dict written by ``emg3d_tpu.Simulation.to_dict`` is read as it is;
    it names no device, so the simulation is placed on the card."""
    ref, out = pair
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t3.Simulation.from_dict(ref.to_dict(what='all', copy=True))
    sim = from_emg3d_tpu(ref, device='cpu')
    assert isinstance(sim, t3.Simulation) and sim.device == 'cpu'
    assert isinstance(sim.survey, t3.Survey)
    assert isinstance(sim.model, t3.Model)
    assert isinstance(sim.get_efield('TxED-1', 'f-1'), t3.Field)
    assert_array_equal(np.asarray(sim.data.synthetic),
                       np.asarray(ref.data.synthetic))
    assert_array_equal(sim.gradient, ref.gradient)
    assert sim.tol_gradient == ref.tol_gradient == 5e-7


@pytest.mark.parametrize('ext', ['h5', 'npz', 'json'])
@pytest.mark.parametrize('what', ['computed', 'results', 'plain'])
def test_file_roundtrip(pair, tmp_path, ext, what):
    ref, out = pair
    fname = str(tmp_path / f'sim.{ext}')
    out.to_file(fname, what=what)
    back = t3.Simulation.from_file(fname)
    assert back.device == 'cpu' and back.solver_opts['device'] == 'cpu'
    assert back.solver_opts['plain'] and back.gridding == 'same'
    assert_array_equal(np.asarray(back.data.observed),
                       np.asarray(out.data.observed))
    if what == 'plain':
        assert not back._computed
        assert np.all(np.isnan(np.asarray(back.data.synthetic)))
    else:
        assert back._computed and back.misfit == out.misfit
        assert_array_equal(np.asarray(back.data.synthetic),
                           np.asarray(out.data.synthetic))
        assert_array_equal(back.gradient, out.gradient)
    if what == 'computed':
        assert_array_equal(back.get_efield('TxED-2', 'f-2').field,
                           out.get_efield('TxED-2', 'f-2').field)


def test_file_dir_same_as_memory(pair, tmp_path):
    """h5-spill mode: fields live on disk; data, misfit and gradient are
    those of the in-memory run; device and dtype survive the files."""
    ref, out = pair
    model, sim_inp = make_inputs(t3)
    sim_inp['survey'].data['observed'] = np.asarray(
        out.data.observed).copy()
    sim_inp['solver_opts'] = dict(sim_inp['solver_opts'],
                                  dtype=torch.complex128)
    sim = t3.Simulation(model=model, file_dir=str(tmp_path), **sim_inp)
    assert sim.solver_opts['dtype'] == 'complex128'
    grad = sim.gradient
    stored = sim._dict_efield['TxED-1']['f-1']
    assert isinstance(stored, str) and stored.endswith('_out.h5')
    assert isinstance(sim._dict_bfield['TxED-2']['f-2'], str)
    task = t3.load(str(tmp_path / 'efield_TxED-1_f-1.h5'))['data']
    assert task['solver_opts']['device'] == 'cpu'
    assert task['solver_opts']['dtype'] == 'complex128'
    assert_array_equal(np.asarray(sim.data.synthetic),
                       np.asarray(out.data.synthetic))
    assert sim.misfit == out.misfit
    assert_array_equal(grad, out.gradient)
    assert_array_equal(sim.get_efield('TxED-1', 'f-1').field,
                       out.get_efield('TxED-1', 'f-1').field)
    assert sim.get_efield_info('TxED-1', 'f-1')['it_mg'] == \
        out.get_efield_info('TxED-1', 'f-1')['it_mg']
    sim.clean('all')
    assert not list(tmp_path.glob('[ebg]field_*.h5'))


def test_clean(pair):
    out = pair[1].copy()
    out.clean('keepresults')
    assert out._computed and out._gradient is not None
    assert out._dict_efield['TxED-1']['f-1'] is None
    out.clean('all')
    assert not out._computed and out._misfit is None
    assert np.all(np.isnan(np.asarray(out.data.synthetic)))
    assert 'residual' not in out.data.keys()
    with pytest.raises(TypeError, match='Unrecognized'):
        out.clean('nonsense')


def test_device_and_dtype_options(monkeypatch):
    model, sim_inp = make_inputs(t3)
    del sim_inp['device']
    opts = sim_inp['solver_opts']
    # A device inside solver_opts is honoured; the keyword wins over it.
    sim = t3.Simulation(model=model, **{
        **sim_inp, 'solver_opts': dict(opts, device='cpu',
                                       dtype='torch.complex64')})
    assert sim.device == 'cpu' and sim.solver_opts['dtype'] == 'complex64'
    with pytest.raises(ValueError, match='Unsupported working dtype'):
        t3.Simulation(model=model, device='cpu', **{
            **sim_inp, 'solver_opts': dict(opts, dtype='int32')})
    # No device anywhere means the card; without one it raises.
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t3.Simulation(model=model, **sim_inp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t3.Simulation(model=model, **{
            **sim_inp, 'solver_opts': dict(opts, device='cuda')})
    sim = t3.Simulation(model=model, device='cpu', **{
        **sim_inp, 'solver_opts': dict(opts, device='cuda')})
    assert sim.solver_opts['device'] == 'cpu'


def test_constructor_errors():
    model, sim_inp = make_inputs(t3)
    with pytest.raises(TypeError, match='not permitted'):
        t3.Simulation(model=model, gridding_opts={'center': (0, 0, 0)},
                      **sim_inp)
    with pytest.raises(TypeError, match='Unexpected '):
        t3.Simulation(model=model, nonsense=True, **sim_inp)
    sim_inp['survey'] = t3.Survey(
        list(sim_inp['survey'].sources.values()),
        list(sim_inp['survey'].receivers.values()), [1.0],
        data=np.ones((2, 3, 1)))
    sim = t3.Simulation(model=model, **sim_inp)
    with pytest.raises(ValueError, match='standard_deviation'):
        _ = sim.misfit


def test_gradient_refuses_mu_r():
    model, sim_inp = make_inputs(t3)
    model = t3.Model(model.grid, property_x=model.property_x,
                     mu_r=np.full(model.shape, 1.5), mapping='Resistivity')
    sim = t3.Simulation(model=model, **sim_inp)
    sim._computed = True
    sim.survey.data['observed'] = sim.data.synthetic.copy(
        data=np.ones(sim.survey.shape, dtype=complex))
    sim.survey.data['synthetic'] = sim.data.observed.copy()
    with pytest.raises(NotImplementedError, match='magn. permeability'):
        _ = sim.gradient


# --------------------------------------------------------------------------
# Gridding modes: the same grids as the JAX package, without solves.
# --------------------------------------------------------------------------

def auto_sim(mod, gridding, frequencies=(0.5, 2.0), **kwargs):
    """The simulation of tests/test_simulations.py::TestAutoGridding."""
    gopts = kwargs.pop('gridding_opts', {})
    h = np.ones(16) * 200.0
    grid = mod.TensorMesh([h, h, h], origin=(-1600.,) * 3)
    model = mod.Model(grid, property_x=1.0, mapping='Resistivity')
    sources = [mod.TxElectricDipole((x, 0., -200., 0., 0.))
               for x in (-300., 300.)]
    recs = [mod.RxElectricPoint((x, 0., -250., 0., 0.))
            for x in (600., 900.)]
    survey = mod.Survey(sources, recs, list(frequencies),
                        relative_error=0.05)
    if mod is t3:
        kwargs['device'] = 'cpu'
    return mod.Simulation(
        survey=survey, model=model, gridding=gridding,
        gridding_opts=gopts, tqdm_opts=False,
        solver_opts={'plain': True, 'verb': 0}, **kwargs)


def same_grids(out, ref):
    shapes = set()
    for src in out.survey.sources:
        for freq in out.survey.frequencies:
            a, b = out.get_grid(src, freq), ref.get_grid(src, freq)
            assert a.shape_cells == b.shape_cells
            assert_array_equal(a.origin, b.origin)
            for ha, hb in zip(a.h, b.h):
                assert_array_equal(ha, hb)
            shapes.add((id(a), a.shape_cells))
    return shapes


@pytest.mark.parametrize('gridding,ngrids,kwargs', [
    ('same', 1, {}),
    ('single', 1, {}),
    ('frequency', 2, {}),
    ('source', 2, {}),
    ('both', 4, {}),
    ('frequency', 4, dict(frequencies=(0.1, 0.5, 2.0, 8.0),
                          shape_classes=1.7)),
    ('single', 1, dict(gridding_opts={
        'center': (0., 0., -200.), 'properties': [1.0, 2.0],
        'domain': ([-800., 800.], [-800., 800.], [-800., 0.]),
        'min_width_limits': [100., 100.], 'center_on_edge': True})),
])
def test_gridding_modes(gridding, ngrids, kwargs):
    ref = auto_sim(e3, gridding, **dict(kwargs))
    out = auto_sim(t3, gridding, **dict(kwargs))
    grids = same_grids(out, ref)
    assert len({g[0] for g in grids}) == ngrids
    assert out.gridding_opts.keys() == ref.gridding_opts.keys()
    for key, val in ref.gridding_opts.items():
        assert str(out.gridding_opts[key]) == str(val), key
    m = out.get_model('TxED-1', 'f-1')
    assert m.shape == out.get_grid('TxED-1', 'f-1').shape_cells
    assert_array_equal(m.property_x,
                       ref.get_model('TxED-1', 'f-1').property_x)
    back = t3.Simulation.from_dict(out.to_dict('plain', copy=True))
    assert back.shape_classes == out.shape_classes
    same_grids(back, ref)


def test_gridding_input_and_dict():
    h = np.ones(8) * 400.0
    sims = []
    for mod in (e3, t3):
        grid_in = mod.TensorMesh([h, h, h], origin=(-1600.,) * 3)
        sims.append(auto_sim(mod, 'input', gridding_opts=grid_in))
    ref, out = sims
    assert out.get_grid('TxED-1', 'f-1') is out.gridding_opts
    same_grids(out, ref)
    assert out.get_model('TxED-1', 'f-1').shape == (8, 8, 8)
    back = t3.Simulation.from_dict(out.to_dict('plain', copy=True))
    assert back.get_grid('TxED-2', 'f-2') == out.gridding_opts

    # 'dict': the grids of a 'both' simulation, given task by task.
    both = auto_sim(t3, 'both')
    table = {s: {f: both.get_grid(s, f) for f in both.survey.frequencies}
             for s in both.survey.sources}
    sim = auto_sim(t3, 'dict', gridding_opts=table)
    assert sim.get_grid('TxED-2', 'f-1') is table['TxED-2']['f-1']
    back = t3.Simulation.from_dict(sim.to_dict('plain', copy=True))
    assert back.get_grid('TxED-2', 'f-1') == table['TxED-2']['f-1']


def test_input_gridding_solves_like_jax():
    """A task grid other than the model's: the model is interpolated to
    it, the gradient comes back through the volume-average adjoint."""
    h = np.ones(8) * 200.0
    sims = []
    for mod in (e3, t3):
        model, sim_inp = make_inputs(mod, nx=16)
        sim_inp['gridding'] = 'input'
        sim_inp['survey'] = sim_inp['survey'].select(
            sources='TxED-1', frequencies='f-1')
        sim_inp['survey'].data['observed'] = sim_inp['survey'].data[
            'observed'].copy(data=np.full((1, 3, 1), 1e-12 + 1e-12j))
        grid_in = mod.TensorMesh([h, h, h], origin=(-800.,) * 3)
        sim = mod.Simulation(model=model, gridding_opts=grid_in, **sim_inp)
        _ = sim.gradient
        sims.append(sim)
    ref, out = sims
    assert out.get_efield('TxED-1', 'f-1').grid.shape_cells == (8, 8, 8)
    assert (out.get_efield_info('TxED-1', 'f-1')['it_mg']
            == ref.get_efield_info('TxED-1', 'f-1')['it_mg'])
    close(out.data.synthetic, ref.data.synthetic)
    assert_allclose(out.misfit, ref.misfit, rtol=1e-8)
    assert out.gradient.shape == (2, 16, 16, 16)
    close(out.gradient, ref.gradient)
