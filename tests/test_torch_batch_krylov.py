"""PyTorch port, the batched MG-preconditioned BiCGSTAB against
``emg3d_tpu.parallel.batch``: the problem of tests/test_torch_batch.py
(random triaxial model, 8^3 cells, three frequencies, complex128 on the
CPU).

- BiCGSTAB preconditioned by F-cycles with semicoarsening and line
  relaxation, lane by lane against the JAX package to the tolerances of
  tests/test_torch_batch.py (the same ``it_ssl`` and ``it_mg``).  One
  fixed direction each (``semicoarsening=3``, ``linerelaxation=3``: no
  z-coarsening, z-lines, a permuted frame): the JAX package compiles
  every smoother variant of a cycling configuration, minutes for the
  full one.  The full production configuration (sc cycling 1-2-3, lr
  cycling 4-5-6) is held against the port's sequential ``solve`` in
  tests/test_torch_batch.py and card against CPU in
  tests/test_torch_cuda.py and ``chip_smoke.py``.
- Active shrink of the batched BiCGSTAB (after its first step, tasks 1
  and 2 with zero sources) equals no shrink to 1e-12, in the port.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu.parallel import batch as jbatch
from test_torch_batch import FREQS, assert_lanes, problem

KRYLOV = dict(sslsolver=True, semicoarsening=3, linerelaxation=3, tol=1e-8)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def test_bicgstab_batch_equals_jax():
    out = t3.solve_batch_fields(*problem(t3), device='cpu', **KRYLOV)
    ref = jbatch.solve_batch_fields(*problem(e3), **KRYLOV)
    assert_lanes(out, ref)
    assert out[1]['it_ssl'] > 0 and out[1]['it_mg'] > 0
    assert out[1]['exit_messages'] == ['CONVERGED'] * len(FREQS)
    assert np.all(out[1]['rel_error'] < 1e-8)


def test_bicgstab_shrink_equals_no_shrink(monkeypatch, capsys):
    # Point smoothing keeps the CPU run short; the step count is fixed
    # and the tolerance out of reach, so the active lane is still active
    # when the shrink is looked at.
    kw = dict(sslsolver=True, tol=1e-13, maxit=2, verb=4)

    def run():
        model, sfields = problem(t3, zero=(1, 2))
        return t3.solve_batch_fields(model, sfields, device='cpu', **kw)

    ref = run()
    assert 'batch shrunk' not in capsys.readouterr().out
    monkeypatch.setenv('EMG3D_TPU_BATCH_SHRINK', '1')
    out = run()
    assert 'batch shrunk to 1/3 lanes' in capsys.readouterr().out
    assert_lanes(out, ref, tol=1e-12)
    assert out[1]['it_ssl'] == 2
    for f in out[0][1:]:
        assert np.all(f.field == 0)
