"""PyTorch port, ``Simulation``: the default solver against the JAX
package, and the physics oracles on the port alone.

- The default solver (MG-preconditioned BiCGSTAB, semicoarsening, line
  relaxation; no solver option but ``tol``) on an 8^3 VTI survey of 2
  sources at one frequency (2 x 2 tasks are held in
  tests/test_torch_sim.py), in complex128 on the CPU in both packages:
  the same ``it_ssl`` and ``it_mg`` per task, synthetic data, misfit and
  gradient to rtol 1e-8 (atol 1e-8 of the largest entry), ``jvec`` to
  rtol 1e-7.  The JAX simulation is rebuilt (its ``from_dict``) from
  what it stored, ``to_dict('all')`` after its gradient, with its
  ``jvec``: read from tests/data/torch_reference.npz, which
  tests/create_data/torch_reference.py writes from the JAX package.
- On the port alone (``device='cpu'``, plain F-cycles), after
  tests/test_simulations.py: the adjoint identity <w, Re(J v)> = <v, J^T w>
  to 1e-4 for isotropic, HTI, VTI and triaxial models under four property
  maps (8^3 cells); the adjoint-state gradient against a finite difference
  of the misfit on 16^3 cells, NRMSD < 1.5 %; ``jtvec`` of the weighted residual is the
  gradient.
"""

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_allclose

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu_torch import maps
from torch_reference import reference


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def make_inputs(mod=t3, nx=16, mapping='Resistivity', anisotropy='isotropic',
                nsrc=1, nfreq=1, solver_opts=None):
    """The fullspace survey of tests/test_simulations.py, by ``mod``: a
    cube of 1600 m a side in ``nx``^3 cells."""
    h = np.ones(nx) * 1600.0 / nx
    grid = mod.TensorMesh([h, h, h], origin=(-800.,) * 3)
    pmap = getattr(maps, 'Map' + mapping)()
    inp = {'grid': grid, 'mapping': mapping, 'property_x': pmap.forward(1.0)}
    if anisotropy in ('HTI', 'triaxial'):
        inp['property_y'] = pmap.forward(1.1)
    if anisotropy in ('VTI', 'triaxial'):
        inp['property_z'] = pmap.forward(1.4)
    model = mod.Model(**inp)
    src_x = [0.] if nsrc == 1 else list(np.linspace(-100., 100., nsrc))
    sources = [mod.TxElectricDipole((x, 0., 0., 0., 0.)) for x in src_x]
    # The z-offset keeps Hy of the x-dipole away from its symmetry zero.
    receivers = [mod.RxElectricPoint((x, 50., 0., 0., 0.))
                 for x in (250., 350.)]
    receivers += [mod.RxMagneticPoint((300., 0., 100., 90., 0.))]
    survey = mod.Survey(sources, receivers, [1.0, 2.0][:nfreq],
                        relative_error=0.05, noise_floor=1e-17)
    sim_inp = {
        'survey': survey, 'gridding': 'same',
        'receiver_interpolation': 'linear', 'tqdm_opts': False,
        'solver_opts': solver_opts or {'plain': True, 'tol': 5e-7,
                                       'verb': 0},
    }
    if mod is t3:
        sim_inp['device'] = 'cpu'
    return model, sim_inp


def with_observed(mod, scale, **kw):
    """Simulation inputs whose observed data are the responses of the
    model with its resistivities times ``scale``."""
    model, sim_inp = make_inputs(mod, **kw)
    true = model.copy()
    for name in ('property_x', 'property_y', 'property_z'):
        if getattr(model, name) is not None:
            setattr(true, name, scale * getattr(model, name))
    sim = mod.Simulation(model=true, **sim_inp)
    sim.compute(observed=True, add_noise=False)
    sim_inp['survey'] = sim_inp['survey'].copy()
    sim_inp['survey'].data['observed'] = np.asarray(
        sim.data.observed).copy()
    return model, sim_inp


# --------------------------------------------------------------------------
# The default solver, against the JAX package.
# --------------------------------------------------------------------------

def default_options():
    """The survey of ``default_pair``: 2 sources, VTI, 8^3, the default
    solver to 1e-6."""
    return dict(nx=8, anisotropy='VTI', nsrc=2, nfreq=1,
                solver_opts={'tol': 1e-6, 'verb': 0})


def jvec_vector():
    """The model vector of test_default_solver_jvec."""
    return np.random.default_rng(44).normal(size=(2, 8, 8, 8))


def default_inputs():
    """What the JAX simulation of ``default_pair`` depends on (its
    observed data are its own responses, the resistivities times 1.2)."""
    return (*make_inputs(t3, **default_options()), 1.2, jvec_vector())


@pytest.fixture(scope='module')
def default_pair():
    """(the JAX simulation, rebuilt from the file, its ``jvec`` of
    ``jvec_vector()`` as ``jvec_v``; the port's), each with its observed
    data, misfit and gradient."""
    ref = reference('sim_grad.default', *default_inputs())
    jsim = e3.Simulation.from_dict(ref['simulation'])
    jsim.jvec_v = ref['jvec']
    model, sim_inp = with_observed(t3, 1.2, **default_options())
    sim = t3.Simulation(model=model, **sim_inp)
    _ = sim.gradient
    return jsim, sim


def close(a, b, rtol=1e-8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize('src', ['TxED-1', 'TxED-2'])
def test_default_solver_tasks(default_pair, src):
    ref, out = default_pair
    freq = 'f-1'
    for which in ('efield', 'bfield'):
        a = out._dict_get(f'{which}_info', src, freq)
        b = ref._dict_get(f'{which}_info', src, freq)
        assert a['it_ssl'] == b['it_ssl'] > 0
        assert a['it_mg'] == b['it_mg'] > 0
        assert a['exit'] == b['exit'] == 0
        assert a['rel_error'] < 1e-6
        close(out._dict_get(which, src, freq).field,
              ref._dict_get(which, src, freq).field)


def test_default_solver_data_misfit_gradient(default_pair):
    ref, out = default_pair
    close(out.data.observed, ref.data.observed)
    close(out.data.synthetic, ref.data.synthetic)
    assert out.misfit > 0
    assert_allclose(out.misfit, ref.misfit, rtol=1e-8)
    assert out.gradient.shape == (2, 8, 8, 8)
    close(out.gradient, ref.gradient)


def test_default_solver_jvec(default_pair):
    ref, out = default_pair
    close(out.jvec(jvec_vector()), ref.jvec_v, rtol=1e-7)


# --------------------------------------------------------------------------
# Physics oracles, on the port alone.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("anisotropy,mapping,vshape", [
    ('isotropic', 'Resistivity', ()),
    ('HTI', 'LnConductivity', (2,)),
    ('VTI', 'LgResistivity', (2,)),
    ('triaxial', 'Conductivity', (3,)),
])
def test_jvec_jtvec_adjoint(anisotropy, mapping, vshape):
    model, sim_inp = make_inputs(nx=8, mapping=mapping,
                                 anisotropy=anisotropy)
    sim = t3.Simulation(model=model, **sim_inp)
    sim.compute(observed=True, add_noise=False)

    rng = np.random.default_rng(11)
    v = rng.standard_normal((*vshape, *model.grid.shape_cells))
    w = rng.standard_normal(sim.survey.shape)
    lhs = np.sum(w * sim.jvec(v).real)
    rhs = np.sum(v * sim.jtvec(w))
    assert lhs != 0
    assert abs(lhs - rhs) <= 1e-4 * (abs(lhs) + abs(rhs)) / 2


@pytest.fixture(scope='module')
def misfit_sim():
    model, sim_inp = with_observed(t3, 1.2)
    sim = t3.Simulation(model=model, **sim_inp)
    _ = sim.gradient
    return model, sim_inp, sim


def test_as_vs_fd_gradient(misfit_sim):
    """Adjoint-state against finite-difference gradient (NRMSD < 1.5 %)."""
    model, sim_inp, sim = misfit_sim
    grad = sim.gradient
    assert grad.shape == (16, 16, 16)

    # A cell with a significant gradient, away from source and boundary.
    cgrad = grad.copy()
    cgrad[6:10, 6:10, 6:10] = 0.0
    ix, iy, iz = np.unravel_index(np.argmax(abs(cgrad)), cgrad.shape)

    epsilon = 1e-4
    model_diff = model.copy()
    model_diff.property_x[ix, iy, iz] += epsilon
    # On a copy of the survey: a simulation writes its responses there.
    sim_fd = t3.Simulation(model=model_diff, **{
        **sim_inp, 'survey': sim_inp['survey'].copy()})
    fdgrad = float((sim_fd.misfit - sim.misfit) / epsilon)

    nrmsd = 200 * abs(grad[ix, iy, iz] - fdgrad)
    nrmsd /= abs(grad[ix, iy, iz]) + abs(fdgrad)
    assert nrmsd < 1.5


def test_jtvec_equals_gradient(misfit_sim):
    """jtvec(residual * weights) reproduces the gradient."""
    model, sim_inp, sim = misfit_sim
    sim = sim.copy()
    grad = sim.gradient.copy()
    vec = np.asarray(sim.data.residual) * np.asarray(sim.data.weights)
    assert_allclose(sim.jtvec(vec), grad, rtol=1e-10)


def test_cubic_interpolation_warns(misfit_sim):
    model, sim_inp, sim = misfit_sim
    sim = sim.copy('all')
    sim.receiver_interpolation = 'cubic'
    sim._gradient = None
    with pytest.warns(UserWarning, match='cubic interpolation'):
        _ = sim.gradient
