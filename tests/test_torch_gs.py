"""PyTorch port, point Gauss-Seidel phase against the JAX package.

The plain PyTorch phase (``smoothers._gauss_seidel_phase_torch``, the
reference the CUDA kernel is held against) must agree with
``emg3d_tpu.ops.smoothers.gauss_seidel_phase`` and with the split-real
core of the Pallas kernels (``pallas_gs.gauss_seidel_phase_split``) for
every color, complex128 on the CPU, rtol 1e-12; so must the two-color
sweep (``gauss_seidel_sweep``), rtol 1e-11.  The JAX package's phases and
sweeps are read from tests/data/torch_reference.npz (written by
tests/create_data/torch_reference.py from the JAX package).  The kernel
itself runs only on a CUDA card: tests/test_torch_cuda.py holds it
against this plain version there.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from emg3d_tpu.ops import pallas_gs, smoothers
from emg3d_tpu_torch.ops import _build, gs_phase
from emg3d_tpu_torch.ops import smoothers as t_smoothers
from torch_reference import fields, reference

COLORS = list(itertools.product((0, 1), repeat=3))


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_problem(seed=5, nx=9, ny=8, nz=7):
    """numpy operands on the pattern of tests/test_pallas_gs.py."""
    rng = np.random.default_rng(seed)
    hx = rng.uniform(20, 60, nx)
    hy = rng.uniform(20, 60, ny)
    hz = rng.uniform(20, 60, nz)
    shp = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
           (nx + 1, ny + 1, nz)]

    def f(s):
        return rng.normal(size=s) + 1j * rng.normal(size=s)

    e = tuple(f(s) for s in shp)
    s = tuple(f(s_) for s_ in shp)
    eta = tuple(-(rng.uniform(1e3, 5e3, (nx, ny, nz)))
                + 1j * rng.uniform(1e2, 5e2, (nx, ny, nz)) for _ in range(3))
    zeta = rng.uniform(1e3, 2e3, (nx, ny, nz))
    return e, s, eta, zeta, (hx, hy, hz)


def _jax(e, s, eta, zeta, h):
    return [jnp.asarray(a) for a in (*e, *s, *eta, zeta, *h)]


def _torch(e, s, eta, zeta, h):
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (*e, *s, *eta, zeta, *h)]


def _close(out, ref, rtol):
    for a, b in zip(out, ref):
        assert_allclose(a.cpu().numpy(), np.asarray(b), rtol=rtol)


def phase_case(color):
    """The name of a case of test_plain_phase_equals_jax."""
    return 'gs.phase.' + ''.join(map(str, color))


@pytest.mark.parametrize('color', COLORS)
def test_plain_phase_equals_jax(color):
    prob = _random_problem()
    # smoothers.gauss_seidel_phase and pallas_gs.gauss_seidel_phase_split
    # of the JAX package on the same operands.
    stored = reference(phase_case(color), prob, color)
    ref = fields(stored['phase'], prob[0])
    spl = fields(stored['split'], prob[0])
    args = _torch(*prob)
    out = t_smoothers.gauss_seidel_phase(*args, *color)
    assert all(a is b for a, b in zip(out, args[:3]))     # in place
    _close(out, ref, 1e-12)
    _close(out, spl, 1e-12)


def test_full_sweep_equals_jax():
    prob = _random_problem(seed=11)
    # smoothers.gauss_seidel_sweep of the JAX package, each direction, on
    # prob as it is then: the port's sweep relaxes prob's arrays in place.
    stored = reference('gs.sweep', prob)
    for reverse in (False, True):
        ref = fields(stored[str(reverse)], prob[0])
        out = t_smoothers.gauss_seidel_sweep(*_torch(*prob), reverse)
        _close(out, ref, 1e-11)


def test_phase_colors_equal_jax():
    for shape in itertools.product((2, 3, 4), repeat=3):
        for reverse in (False, True):
            assert (t_smoothers.phase_colors(shape, reverse)
                    == smoothers.phase_colors(shape, reverse))
    assert t_smoothers.phase_colors((2, 2, 2), False) == [(0, 0, 0)]


@pytest.mark.slow
def test_plain_phase_equals_pallas_interpret():
    prob = _random_problem(seed=9)
    ref = pallas_gs.gauss_seidel_phase_pallas(*_jax(*prob), 1, 0, 1,
                                              interpret=True)
    out = t_smoothers.gauss_seidel_phase(*_torch(*prob), 1, 0, 1)
    _close(out, ref, 1e-12)


def test_cuda_wrapper_rejects_bad_input():
    args = _torch(*_random_problem(seed=3, nx=4, ny=4, nz=4))
    with pytest.raises(ValueError, match='CUDA'):
        gs_phase.gauss_seidel_phase_cuda(*args, 0, 0, 0)
    launches = gs_phase.LAUNCHES

    class FakeDevice:
        type = 'cuda'

    class Fake:
        """Stands in for a CUDA tensor to reach the dtype check."""
        device = FakeDevice()
        dtype = torch.complex32

    with pytest.raises(TypeError, match='dtype'):
        gs_phase.gauss_seidel_phase_cuda(Fake(), *args[1:], 0, 0, 0)
    assert gs_phase.LAUNCHES == launches


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, '_BUILD', tmp_path / 'build')
    monkeypatch.setattr(_build, '_LIBS', {})
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no-cuda'))
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.Path, 'is_file', lambda self: False)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.load('gs_phase')
