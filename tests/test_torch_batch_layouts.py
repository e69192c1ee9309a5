"""PyTorch port, the batch engine's other layouts against
``emg3d_tpu.parallel.batch``: the problem of tests/test_torch_batch.py
(random triaxial model, 8^3 cells, three frequencies, complex128 on the
CPU), in the layouts for which the JAX package compiles its batched
executables once more.  The JAX package's answers are read from
tests/data/torch_reference.npz (written by
tests/create_data/torch_reference.py from the JAX package).

- The stacked layout (``epsilon_r`` makes eta affine in s: one eta per
  task, stacked on the task axis) lane by lane against the JAX package,
  to the tolerances of tests/test_torch_batch.py.
- Active shrink (``EMG3D_TPU_BATCH_SHRINK=1``, the same variable for both
  packages) with plain multigrid: tasks 1 and 2 have zero sources, so 3
  lanes shrink to 1 before the first cycle; shrink on equals shrink off
  in the port to 1e-12, and equals the JAX package's shrink to 1e-10.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu_torch import models, solver
from emg3d_tpu_torch.parallel import batch as tbatch
from test_torch_batch import (CASES, FREQS, N, assert_lanes, jax_solve,
                              problem)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def test_stacked_layout_equals_jax():
    model, sfields = problem(t3, epsilon_r=True)
    out = t3.solve_batch_fields(model, sfields, device='cpu',
                                **CASES['plain'])
    ref = jax_solve('batch.stacked', CASES['plain'], epsilon_r=True)
    assert_lanes(out, ref)
    assert out[1]['exit_messages'] == ['CONVERGED'] * len(FREQS)
    var = solver.MGParameters(verb=0, sslsolver=False, semicoarsening=False,
                              linerelaxation=False, shape_cells=model.shape,
                              device='cpu')
    vmodels = [models.VolumeModel(model, sf) for sf in sfields]
    meta, levels = tbatch._BatchHierarchies(vmodels, var).get(0, 0)
    assert levels[0].ops[0].shape == (len(FREQS), N, N, N)
    assert levels[0].ops[3].shape == (N, N, N)
    assert levels[0].scale is None and len(meta) == len(levels)


def test_shrink_equals_jax_and_no_shrink(monkeypatch, capsys):
    kw = dict(CASES['plain'], verb=4)

    def run():
        model, sfields = problem(t3, zero=(1, 2))
        return t3.solve_batch_fields(model, sfields, device='cpu', **kw)

    ref_t = run()
    assert 'batch shrunk' not in capsys.readouterr().out
    monkeypatch.setenv('EMG3D_TPU_BATCH_SHRINK', '1')
    out_t = run()
    assert 'batch shrunk to 1/3 lanes' in capsys.readouterr().out
    # The JAX package's run with EMG3D_TPU_BATCH_SHRINK=1, and its output.
    out_j = jax_solve('batch.shrink', kw, zero=(1, 2))
    assert 'batch shrunk to 1/3 lanes' in out_j[1]['stdout']
    assert_lanes(out_t, ref_t, tol=1e-12)
    assert_lanes(out_t, out_j)
    for f in out_t[0][1:]:
        assert np.all(f.field == 0)
