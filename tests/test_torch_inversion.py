"""PyTorch port, ``emg3d_tpu_torch.inversion`` against ``emg3d_tpu.inversion``.

The same inputs, made from a numpy seed, go through both packages on the
CPU:

- ``InversionResult.__repr__``; the roughness functional ``_make_roughness``
  (value and gradient to 1e-12);
- ``_make_objective`` on stub simulations (a quadratic misfit in mapping
  space, after tests/test_inversion.py): ``m0`` in the same order, the
  same value and gradient, and ``set_model`` round trips, for isotropic,
  VTI and triaxial models;
- ``minimize``'s smoothness wiring on the stubs (after
  tests/test_inversion.py), both packages to the same model;
- one objective evaluation of a real 8^3 survey (plain F-cycles): data,
  misfit and gradient to 1e-8;
- the whole-cycle step that every evaluation's solves replay on the card
  (``EMG3D_TPU_CYCLE_JIT=1``; on the CPU it runs its body uncaptured)
  against the JAX package's per-operation solve at 8^3, plain F-cycles,
  to the tolerances of tests/test_torch_solver.py.

The JAX package's evaluation and solve are read from
tests/data/torch_reference.npz (written by
tests/create_data/torch_reference.py from the JAX package).

The three slow inversions of tests/test_inversion.py run on the port
alone, marked ``slow`` as there.
"""

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_allclose

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu.inversion import native as j_native
from emg3d_tpu_torch import solver as t_solver
from emg3d_tpu_torch.convert import from_emg3d_tpu
from emg3d_tpu_torch.inversion import native
from torch_reference import Field, reference

PACKAGES = ((e3, j_native), (t3, native))
CASES = {'isotropic': (), 'VTI': ('property_z',),
         'triaxial': ('property_y', 'property_z')}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def test_lazy_submodules():
    from emg3d_tpu_torch import inversion
    assert inversion.__all__ == ['native', 'pygimli', 'simpeg']
    assert inversion.native is native
    assert inversion.simpeg.__all__ == inversion.pygimli.__all__ == []
    with pytest.raises(AttributeError, match='emg3d_tpu_torch.inversion'):
        inversion.nothing


def test_result_repr():
    kw = dict(model=None, misfit=1.0, misfit0=10.0, n_iterations=3,
              n_evaluations=5, success=True, message='ok')
    out = native.InversionResult(**kw)
    assert repr(out) == repr(j_native.InversionResult(**kw))
    assert 'iterations=3' in repr(out)
    assert out.history == []


def test_roughness_against_jax():
    rng = np.random.default_rng(7)
    shape = (5, 4, 3)
    widths = [rng.uniform(50, 200, n) for n in shape]
    m = rng.standard_normal(shape)
    for axw in ((1.0, 1.0, 1.0), (1.0, 2.5, 0.0), (0.0, 0.0, 3.0)):
        phi, g = native._make_roughness(shape, widths)(m, axw)
        jphi, jg = j_native._make_roughness(shape, widths)(m, axw)
        assert phi > 0
        assert_allclose(phi, jphi, rtol=1e-12)
        assert_allclose(g, jg, rtol=1e-12, atol=1e-12 * np.abs(jg).max())
    phi, g = native._make_roughness(shape, widths)(np.full(shape, 3.14),
                                                   (1.0, 1.0, 1.0))
    assert phi == 0.0 and not g.any()


class _QuadSim:
    """Stub Simulation of package ``mod``: the misfit is ½‖m − m*‖² in
    mapping space over every parameterized property, its gradient
    m − m* in the slot order of ``Simulation.gradient``."""

    def __init__(self, mod, grid, case, targets):
        self._targets = targets
        self._props = ('property_x', *CASES[case])
        self.model = mod.Model(
            grid, mapping='LgResistivity',
            **{p: np.zeros(grid.shape_cells) for p in self._props})
        self.cleaned = 0

    def clean(self, what):
        assert what == 'computed'
        self.cleaned += 1

    def _diff(self):
        return np.stack([np.asarray(getattr(self.model, p)) - t
                         for p, t in zip(self._props, self._targets)])

    @property
    def misfit(self):
        return 0.5 * float((self._diff() ** 2).sum())

    @property
    def gradient(self):
        d = self._diff()
        return d[0] if len(self._props) == 1 else d


def quad_sims(case, shape=(6, 5, 4), seed=3, uniform=False):
    rng = np.random.default_rng(seed)
    targets = [rng.standard_normal(shape) for _ in range(1 + len(
        CASES[case]))]
    h = [np.full(n, 100.0) if uniform else rng.uniform(50, 150, n)
         for n in shape]
    return [_QuadSim(mod, mod.TensorMesh(h, origin=(0., 0., 0.)), case,
                     targets) for mod, _ in PACKAGES]


@pytest.mark.parametrize('case', list(CASES))
def test_objective_against_jax(case):
    (jsim, sim), rng = quad_sims(case), np.random.default_rng(4)
    jfun, jset, jm0 = j_native._make_objective(jsim)
    fun, set_model, m0 = native._make_objective(sim)
    props = ('property_x', *CASES[case])
    nblock = sim.model.grid.n_cells
    assert_allclose(m0, jm0, rtol=0, atol=0)
    assert m0.size == len(props) * nblock

    m = rng.standard_normal(m0.size)
    phi, grad = fun(m)
    jphi, jgrad = jfun(m)
    assert_allclose(phi, jphi, rtol=1e-12)
    assert_allclose(grad, jgrad, rtol=1e-12, atol=1e-12)
    assert sim.cleaned == 1 and sim.model.case == case

    # set_model round trip: one F-ordered block per property, in order.
    set_model(m)
    for i, p in enumerate(props):
        assert_allclose(getattr(sim.model, p),
                        m[i * nblock:(i + 1) * nblock].reshape(
                            sim.model.shape, order='F'), rtol=0, atol=0)
    assert sim.model.map.name == 'LgResistivity'
    assert_allclose(native._make_objective(sim)[2], m, rtol=0, atol=0)


@pytest.mark.parametrize('smoothness', [0.0, 1e5, (0.0, 0.0, 1e5)])
def test_minimize_smoothness_wiring(smoothness):
    jsim, sim = quad_sims('isotropic', (6, 6, 6), uniform=True)
    kw = dict(maxiter=60, method='L-BFGS-B', verb=0, tol=1e-12,
              smoothness=smoothness)
    res = native.minimize(sim, **kw)
    jres = j_native.minimize(jsim, **kw)
    assert res.model is sim.model
    m, jm = (np.asarray(r.model.property_x) for r in (res, jres))
    assert_allclose(m, jm, rtol=1e-10, atol=1e-10)
    assert_allclose(res.misfit, jres.misfit, rtol=1e-10, atol=1e-14)
    assert (res.n_iterations, res.n_evaluations) == (
        jres.n_iterations, jres.n_evaluations)

    # As in tests/test_inversion.py: no smoothness recovers the target,
    # strong smoothness a smoother model, z-only smoothing leaves x/y.
    target = sim._targets[0]
    if smoothness == 0.0:
        assert_allclose(m, target, atol=1e-4)
    else:
        dz = float((np.diff(m, axis=2) ** 2).sum())
        dx = float((np.diff(m, axis=0) ** 2).sum())
        dx0 = float((np.diff(target, axis=0) ** 2).sum())
        assert res.misfit > 0
        if np.ndim(smoothness) == 0:
            assert dx < 0.2 * dx0
        else:
            assert dz < 0.05 * dx


def survey_sim(mod, grid, lgres, survey, **kw):
    kw = dict(survey=survey, gridding='same', verb=-1,
              receiver_interpolation='linear', **kw)
    if mod is t3:
        kw['device'] = 'cpu'
    return mod.Simulation(model=mod.Model(grid, property_x=lgres,
                                          mapping='LgResistivity'), **kw)


def small_survey(mod):
    return mod.Survey(
        sources=mod.TxElectricPoint((-200.0, 0, 250, 0, 0)),
        receivers=[mod.RxElectricPoint((x, y, -250, 0, 0))
                   for x in (-250.0, 250.0) for y in (-150.0, 150.0)],
        frequencies=1.0, noise_floor=1e-17, relative_error=0.01)


def evaluation_inputs():
    """(widths, true and start models, solver options) of
    test_evaluation_against_jax."""
    rng = np.random.default_rng(12)
    h = rng.uniform(80.0, 120.0, 8)
    lg_true = np.zeros((8, 8, 8))
    lg_true[2:5, 3:6, 3:6] = -0.7
    lg0 = 0.1 * rng.standard_normal((8, 8, 8))
    sopts = {'plain': True, 'tol': 1e-7, 'verb': 0}
    return h, lg_true, lg0, sopts


def evaluate(mod, nat, observed=None):
    """One objective evaluation by package ``mod`` (observed data by the
    same package where ``observed`` is None): observed, and (synthetic,
    phi, gradient)."""
    h, lg_true, lg0, sopts = evaluation_inputs()
    grid = mod.TensorMesh([h, h, h], origin=(-0.5 * h.sum(),) * 3)
    survey = small_survey(mod)
    if observed is None:
        true = survey_sim(mod, grid, lg_true, survey, solver_opts=sopts)
        true.compute(observed=True, add_noise=False)
        observed = np.asarray(survey.data.observed).copy()
    survey.data['observed'] = observed
    sim = survey_sim(mod, grid, lg0, survey, solver_opts=sopts)
    fun, _, m0 = nat._make_objective(sim)
    phi, grad = fun(m0)
    return observed, (np.asarray(sim.data.synthetic).copy(), phi, grad)


def test_evaluation_against_jax():
    """One objective evaluation of an 8^3 survey (a conductive block,
    observed by the port, from a rough start) in both packages; the JAX
    package's evaluation, of the port's observed data, is read from the
    file (it was made from them)."""
    out = {}
    _, out[t3] = evaluate(t3, native)
    ref = reference('inversion.evaluation', *evaluation_inputs(),
                    small_survey(t3))
    out[e3] = ref['synthetic'], ref['phi'], ref['gradient']
    for a, b in zip(out[t3], out[e3]):
        assert np.all(np.isfinite(a)) and np.abs(b).max() > 0
        assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max())


def steps_problem():
    """A triaxial model on a stretched 8^3 grid and its source field, in
    the JAX package's classes."""
    rng = np.random.default_rng(8)
    h = [rng.uniform(40, 80, 8) for _ in range(3)]
    grid = e3.TensorMesh(h, origin=tuple(-0.5 * x.sum() for x in h))
    cells = grid.shape_cells
    model = e3.Model(grid, property_x=rng.uniform(1, 3, cells),
                     property_y=2.0, property_z=rng.uniform(2, 5, cells))
    sfield = e3.get_source_field(grid, (0., 0., 0., 0., 0.), 1.0)
    return model, sfield


def test_steps_against_jax(monkeypatch):
    """``=1`` on the CPU against the JAX package's per-operation solve
    (``EMG3D_TPU_CYCLE_JIT=0``): a triaxial model on a stretched 8^3
    grid, plain F-cycles."""
    model, sfield = steps_problem()
    jinfo = reference('inversion.steps', model, sfield)
    jfield = Field(jinfo['field'])
    monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', '1')
    t_solver._STEPS.clear()
    t_solver.reset_counts()
    efield, info = t_solver.solve(
        from_emg3d_tpu(model), from_emg3d_tpu(sfield), plain=True,
        tol=1e-6, return_info=True, device='cpu')
    t_solver._STEPS.clear()
    assert t_solver.CYCLE_CAPTURES > 0 and t_solver.CYCLE_REPLAYS > 0
    assert info['it_mg'] == jinfo['it_mg']
    assert info['exit_message'] == jinfo['exit_message'] == 'CONVERGED'
    assert_allclose(info['rel_error'], jinfo['rel_error'], rtol=1e-8)
    assert_allclose(efield.field, jfield.field, rtol=1e-10,
                    atol=1e-10 * np.abs(jfield.field).max())


# --------------------------------------------------------------------------
# The slow inversions of tests/test_inversion.py, on the port.
# --------------------------------------------------------------------------

@pytest.mark.slow
def test_lbfgs_recovers_anomaly():
    grid = t3.TensorMesh([np.full(16, 150.0)] * 3, origin=(-1200,) * 3)
    lgres = np.zeros(grid.shape_cells)
    lgres[6:10, 6:10, 6:10] = -1.0
    survey = t3.Survey(
        sources=[t3.TxElectricPoint((x, 0, 600, 0, 0))
                 for x in (-450.0, 450.0)],
        receivers=[t3.RxElectricPoint((x, y, -600, 0, 0))
                   for x in (-600.0, 0.0, 600.0) for y in (-300.0, 300.0)],
        frequencies=1.0, noise_floor=1e-17, relative_error=0.01)
    survey_sim(t3, grid, lgres, survey).compute(observed=True)
    sim = survey_sim(t3, grid, np.zeros(grid.shape_cells), survey)

    result = native.minimize(sim, maxiter=6, verb=0, bounds=(-2.0, 1.0))

    assert result.misfit0 > 0
    assert result.misfit < 0.35 * result.misfit0
    assert result.n_iterations >= 2
    assert result.model is sim.model
    dm = np.asarray(result.model.property_x)
    inside = dm[6:10, 6:10, 6:10].mean()
    outside = (dm.sum() - dm[6:10, 6:10, 6:10].sum()) / (dm.size - 64)
    assert inside < -0.05
    assert inside < outside - 0.03


def fd_check(sim, rng):
    """The objective's gradient against a central difference of the
    misfit along a random direction."""
    fun, set_model, m0 = native._make_objective(sim)
    phi0, grad = fun(m0)
    assert phi0 > 0 and np.linalg.norm(grad) > 0
    d = rng.standard_normal(m0.size)
    d /= np.linalg.norm(d)
    eps = 1e-3

    def misfit_only(m):
        set_model(m)
        return float(sim.misfit)

    fd = (misfit_only(m0 + eps * d) - misfit_only(m0 - eps * d)) / (2 * eps)
    assert abs(fd - grad @ d) < 0.02 * abs(fd)
    return m0


@pytest.mark.slow
def test_objective_gradient_ordering():
    rng = np.random.default_rng(11)
    grid = t3.TensorMesh(
        [np.full(16, 150.0), np.full(8, 300.0), np.full(12, 200.0)],
        origin=(-1200.0, -1200.0, -1200.0))
    lg_true = np.zeros(grid.shape_cells)
    lg_true[2:8, 1:4, 6:10] = -0.7
    survey = t3.Survey(
        sources=t3.TxElectricPoint((-300, 0, 700, 0, 0)),
        receivers=[t3.RxElectricPoint((x, y, -700, 0, 0))
                   for x in (-600.0, 300.0) for y in (-300.0, 450.0)],
        frequencies=1.0, noise_floor=1e-17, relative_error=0.01)
    survey_sim(t3, grid, lg_true, survey).compute(observed=True)
    lg0 = 0.1 * rng.standard_normal(grid.shape_cells)
    m0 = fd_check(survey_sim(t3, grid, lg0, survey), rng)
    assert_allclose(m0, lg0.ravel(order='F'))


@pytest.mark.slow
def test_vti_objective_gradient():
    rng = np.random.default_rng(7)
    grid = t3.TensorMesh(
        [np.full(12, 200.0), np.full(8, 300.0), np.full(10, 250.0)],
        origin=(-1200.0, -1200.0, -1250.0))
    sopts = {'plain': True, 'tol': 5e-7, 'verb': 0}
    lg_true = np.zeros(grid.shape_cells)
    lg_true[2:6, 1:4, 4:8] = -0.6
    survey = t3.Survey(
        sources=t3.TxElectricPoint((-300, 0, 800, 0, 0)),
        receivers=[t3.RxElectricPoint((x, y, -800, 0, 0))
                   for x in (-500.0, 400.0) for y in (-300.0, 300.0)],
        frequencies=1.0, noise_floor=1e-17, relative_error=0.01)
    common = dict(survey=survey, gridding='same', verb=-1, device='cpu',
                  receiver_interpolation='linear', solver_opts=sopts)
    t3.Simulation(model=t3.Model(grid, lg_true, property_z=lg_true + 0.2,
                                 mapping='LgResistivity'),
                  **common).compute(observed=True)
    lg0x = 0.1 * rng.standard_normal(grid.shape_cells)
    lg0z = 0.1 * rng.standard_normal(grid.shape_cells)
    sim = t3.Simulation(model=t3.Model(grid, lg0x, property_z=lg0z,
                                       mapping='LgResistivity'), **common)
    m0 = fd_check(sim, rng)
    assert m0.size == 2 * grid.n_cells
    assert_allclose(m0[:grid.n_cells], lg0x.ravel(order='F'))
    assert_allclose(m0[grid.n_cells:], lg0z.ravel(order='F'))
