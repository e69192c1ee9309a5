"""PyTorch port, the hand-written CUDA kernels on the card.

Imports neither JAX nor emg3d_tpu, so it also runs on a machine with a
CUDA card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py

Elsewhere every test skips (the kernels have no CPU mode).  The kernel is
held against its plain PyTorch version on the same card, norm-wise per
output array: complex128/float64 to 1e-12 (same arithmetic, another
order and FMA contraction), complex64/float32 to 1e-5.
"""

import itertools

import numpy as np
import pytest
import torch

from emg3d_tpu_torch.ops import gs_phase, smoothers

COLORS = list(itertools.product((0, 1), repeat=3))
DTYPES = [(torch.complex128, torch.float64, 1e-12),
          (torch.complex64, torch.float32, 1e-5),
          (torch.float64, torch.float64, 1e-12),
          (torch.float32, torch.float32, 1e-5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the gs_phase kernel has no CPU mode')
    return torch.device('cuda')


def _operands(shape, dtype, rdt, device, seed=21):
    """Random phase operands (numpy seed) on ``device``."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    shp = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz),
           (nx, ny, nz)]
    cplx = dtype.is_complex

    def f(s, lo=-1., hi=1., im=(-1., 1.)):
        a = rng.uniform(lo, hi, s)
        if cplx:
            a = a + 1j * rng.uniform(*im, s)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    # eta of the size of the curl-curl terms (~4 zeta / h^2), so that
    # neither dominates the 6x6 systems.
    e = [f(s) for s in shp[:3]]
    s = [f(s) for s in shp[:3]]
    eta = [f(shp[3], -5., -1., (1., 5.)) for _ in range(3)]
    zeta = torch.from_numpy(rng.uniform(1e3, 2e3, shp[3])).to(device, rdt)
    h = [torch.from_numpy(rng.uniform(20, 60, n)).to(device, rdt)
         for n in shape]
    return [*e, *s, *eta, zeta, *h]


def _rel_err(out, ref, base):
    """Worst ||a - b|| / ||b|| over ex/ey/ez, on the entries the plain
    version changed."""
    err = 0.0
    for a, b, c in zip(out[:3], ref[:3], base[:3]):
        mask = b != c
        if mask.any():
            err = max(err, float(torch.linalg.vector_norm(a[mask] - b[mask])
                                 / torch.linalg.vector_norm(b[mask])))
    return err


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rdt,tol', DTYPES)
@pytest.mark.parametrize('shape', [(11, 10, 9), (2, 2, 2), (4, 3, 2)])
def test_kernel_equals_plain(cuda, dtype, rdt, tol, shape):
    base = _operands(shape, dtype, rdt, cuda)
    for color in smoothers.phase_colors(shape, False):
        ref = [t.clone() for t in base]
        out = [t.clone() for t in base]
        smoothers._gauss_seidel_phase_torch(*ref, *color)
        launches = gs_phase.LAUNCHES
        smoothers.gauss_seidel_phase(*out, *color)
        torch.cuda.synchronize()
        assert gs_phase.LAUNCHES == launches + 1
        assert any(not torch.equal(b, c) for b, c in zip(ref, base))
        err = _rel_err(out, ref, base)
        assert err <= tol, (color, err)


@pytest.mark.cuda
def test_empty_phase_launches_nothing(cuda):
    args = _operands((2, 2, 2), torch.complex64, torch.float32, cuda)
    launches = gs_phase.LAUNCHES
    before = [t.clone() for t in args[:3]]
    gs_phase.gauss_seidel_phase_cuda(*args, 1, 0, 0)
    assert gs_phase.LAUNCHES == launches
    for a, b in zip(args[:3], before):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(cuda):
    args = _operands((5, 4, 3), torch.complex64, torch.float32, cuda)
    bad_dtype = list(args)
    bad_dtype[3] = bad_dtype[3].to(torch.complex128)
    bad_shape = list(args)
    bad_shape[6] = bad_shape[6][:, :, :2]
    non_contig = list(args)
    non_contig[9] = non_contig[9].transpose(0, 1).contiguous().transpose(0, 1)
    cpu = list(args)
    cpu[4] = cpu[4].cpu()
    for bad, exc in ((bad_dtype, TypeError), (bad_shape, ValueError),
                     (non_contig, ValueError), (cpu, ValueError)):
        with pytest.raises(exc):
            gs_phase.gauss_seidel_phase_cuda(*bad, 0, 0, 0)
