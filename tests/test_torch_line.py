"""PyTorch port, line relaxation against the JAX package.

The plain PyTorch line phase (``smoothers._line_relax_phase_torch``, the
reference the ``line_phase`` CUDA kernel is held against) must agree with
``emg3d_tpu.ops.smoothers.gauss_seidel_line_phase`` (the strided XLA form)
for every axis and color, on an even and an odd stretched shape, in
complex128 and float64 on the CPU, to rtol 1e-12; so must the batched
5x5 solve and the block-Thomas solve on random diagonally dominant
complex-symmetric blocks.  The JAX package's phases and its two-sweep
``gauss_seidel_line`` are read from tests/data/torch_reference.npz
(written by tests/create_data/torch_reference.py from the JAX package,
with its scans not unrolled).  The kernel itself runs only on a CUDA card:
tests/test_torch_cuda.py holds it against this plain version there.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from emg3d_tpu.ops import smoothers
from emg3d_tpu_torch.ops import line_phase
from emg3d_tpu_torch.ops import smoothers as t_smoothers
from torch_reference import fields, reference

SHAPES = [(6, 4, 8), (5, 7, 3)]


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # One torch thread; the JAX scans not unrolled (the unroll changes no
    # arithmetic, only the compile time).
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('EMG3D_TPU_SCAN_UNROLL', '1')
        yield
    torch.set_num_threads(n)


def _problem(shape, complex_, seed=11):
    """numpy operands on a stretched grid; eta of the size of the
    curl-curl terms, so that neither dominates the line systems."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    h = [50 * (1 + rng.random(n)) for n in shape]
    shp = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
           (nx + 1, ny + 1, nz)]

    def f(s, scale=1.0):
        a = rng.normal(size=s)
        if complex_:
            a = a + 1j * rng.normal(size=s)
        return scale * a

    e = tuple(f(s) for s in shp)
    s = tuple(f(s_) for s_ in shp)
    eta = tuple(-rng.uniform(0.5, 2.0, shape)
                + (1j * rng.uniform(0.5, 2.0, shape) if complex_ else 0)
                for _ in range(3))
    zeta = rng.uniform(1e3, 2e3, shape)
    return [*e, *s, *eta, zeta, *h]


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args):
    return [torch.from_numpy(np.array(a, order="C")) for a in args]


def _close(out, ref, rtol=1e-12):
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('reverse', [False, True])
def test_line_phase_colors(axis, reverse):
    for shape in itertools.product((2, 3, 4), repeat=3):
        assert (t_smoothers.line_phase_colors(shape, axis, reverse)
                == smoothers.line_phase_colors(shape, axis, reverse))


def _blocks(rng, batch, n=None):
    """Random diagonally dominant complex-symmetric 5x5 blocks."""
    shape = batch if n is None else (n, *batch)
    a = rng.normal(size=(*shape, 5, 5)) + 1j * rng.normal(size=(*shape, 5, 5))
    a = a + np.swapaxes(a, -1, -2)
    return a + 20 * np.eye(5)


def test_solve_banded_5x5():
    rng = np.random.default_rng(3)
    mat = _blocks(rng, (4, 3))
    rhs = rng.normal(size=(4, 3, 5, 6)) + 1j * rng.normal(size=(4, 3, 5, 6))
    ref = smoothers.solve_banded_5x5(jnp.asarray(mat), jnp.asarray(rhs))
    out = t_smoothers.solve_banded_5x5(torch.from_numpy(mat),
                                       torch.from_numpy(rhs))
    _close([out], [ref])
    assert_allclose(mat @ out.numpy(), rhs, rtol=1e-12, atol=1e-12)


def test_block_thomas():
    rng = np.random.default_rng(4)
    n, batch = 7, (3, 2)
    mid = _blocks(rng, batch, n)
    left = 0.3 * (rng.normal(size=(n, *batch, 5, 5))
                  + 1j * rng.normal(size=(n, *batch, 5, 5)))
    rhs = rng.normal(size=(n, *batch, 5)) + 1j * rng.normal(size=(n, *batch, 5))
    ref = smoothers._block_thomas(*_jax([mid, left, rhs]))
    out = t_smoothers._block_thomas(*_torch([mid, left, rhs]))
    _close([out], [ref])

    # It solves the block-tridiagonal system with super-diagonal L^T.
    res = np.einsum('g...ij,g...j->g...i', mid, out.numpy())
    res[1:] += np.einsum('g...ij,g...j->g...i', left[1:], out.numpy()[:-1])
    res[:-1] += np.einsum('g...ji,g...j->g...i', left[1:], out.numpy()[1:])
    assert_allclose(res, rhs, rtol=1e-12, atol=1e-12 * np.abs(rhs).max())


def phases_case(axis, shape, complex_):
    """The name of a case of test_line_phase_equals_jax."""
    return f"line.phases.{axis}.{'x'.join(map(str, shape))}.{complex_}"


def phases_inputs(axis, shape, complex_):
    """(operands, colors, axis) of a case of test_line_phase_equals_jax."""
    colors = tuple(t_smoothers.line_phase_colors(shape, axis, False))
    return _problem(shape, complex_), colors, axis


@pytest.mark.parametrize('complex_', [True, False])
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('axis', [0, 1, 2])
def test_line_phase_equals_jax(axis, shape, complex_):
    prob, colors, _ = inputs = phases_inputs(axis, shape, complex_)
    assert len(colors) == 4
    # Each color's smoothers.gauss_seidel_line_phase on the same operands.
    ref = reference(phases_case(axis, shape, complex_), *inputs)
    refs = [fields(ref[str(i)], prob[:3]) for i in range(len(colors))]
    for color, ref in zip(colors, refs):
        args = _torch(prob)
        out = t_smoothers.gauss_seidel_line_phase(*args, *color, axis)
        assert all(a is b for a, b in zip(out, args[:3]))     # in place
        _close(out, ref)
        # The phase changed the fields.
        assert any(not np.array_equal(a.numpy(), b)
                   for a, b in zip(out, prob[:3]))


def test_plain_calls_counted_only_on_cuda():
    prob = _torch(_problem((4, 4, 4), True))
    before = line_phase.PLAIN_CALLS_ON_CUDA
    t_smoothers._line_relax_phase_torch(*prob, 0, 0, 1)
    assert line_phase.PLAIN_CALLS_ON_CUDA == before
    with pytest.raises(ValueError, match='axis'):
        t_smoothers._line_relax_phase_torch(*prob, 0, 0, 3)


def test_gauss_seidel_line_nu2():
    shape = (5, 7, 3)
    prob = _problem(shape, True, seed=12)
    # smoothers.gauss_seidel_line(*prob, 2, 1) of the JAX package.
    ref = fields(reference('line.nu2', prob, 2, 1))
    out = t_smoothers.gauss_seidel_line(*_torch(prob), 2, 1)
    _close(out, ref)


def _cpu_operands(shape):
    nx, ny, nz = shape
    edges = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz)]
    e = [torch.zeros(s, dtype=torch.complex64) for s in edges]
    s = [torch.zeros(s, dtype=torch.complex64) for s in edges]
    eta = [torch.zeros(shape, dtype=torch.complex64) for _ in range(3)]
    h = [torch.ones(n) for n in shape]
    return [*e, *s, *eta, torch.ones(shape), *h]


@pytest.mark.parametrize('shape', [(9, 6, 7), (2, 5, 4), (16, 3, 2)])
@pytest.mark.parametrize('axis', [0, 1, 2])
def test_line_geometry(axis, shape):
    """The frame the kernel is launched with: the strides of the permuted
    views and, per parity, the lines the 4-color order implies."""
    args = _cpu_operands(shape)
    ex, ey, ez, zeta = args[0], args[1], args[2], args[9]
    frame, strides, lines = line_phase.line_geometry(
        shape, (ex.stride(), ey.stride(), ez.stride(), zeta.stride()), axis)
    tp = line_phase.FRAMES[axis]
    assert frame == tuple(shape[r] for r in tp)
    fe = [(ex, ey, ez)[r] for r in tp]
    assert list(strides) == [st for t in (*fe, zeta)
                             for st in t.permute(tp).stride()]
    # A parity the sweep skips has no lines; the others have one line per
    # interior transverse node of that parity.
    colors = t_smoothers.line_phase_colors(shape, axis, False)
    assert set(lines) == set(itertools.product((0, 1), repeat=2))
    for (p1, p2), n in lines.items():
        assert (n > 0) == ((p1, p2) in colors)
        assert n == (len(range(1 + p1, frame[1], 2))
                     * len(range(1 + p2, frame[2], 2)))


@pytest.mark.parametrize('call', ['plan', 'wrapper'])
def test_line_plan_rejects_cpu_tensors(call):
    args = _cpu_operands((4, 3, 5))
    launches = line_phase.LAUNCHES
    with pytest.raises(ValueError, match='CUDA device, got cpu'):
        if call == 'plan':
            line_phase.LinePlan(*args, 1)
        else:
            line_phase.gauss_seidel_line_phase_cuda(*args, 0, 0, 1)
    assert line_phase.LAUNCHES == launches
