"""PyTorch port, the batch engine's other layouts against
``emg3d_tpu.parallel.batch``: the problem of tests/test_torch_batch.py
(random triaxial model, 8^3 cells, three frequencies, complex128 on the
CPU), in the layouts for which the JAX package compiles its batched
executables once more.

- The stacked layout (``epsilon_r`` makes eta affine in s: one eta per
  task, stacked on the task axis) lane by lane against the JAX package,
  to the tolerances of tests/test_torch_batch.py.
- Active shrink (``EMG3D_TPU_BATCH_SHRINK=1``, the same variable for both
  packages) with plain multigrid: tasks 1 and 2 have zero sources, so 3
  lanes shrink to 1 before the first cycle; shrink on equals shrink off
  in the port to 1e-12, and equals the JAX package's shrink to 1e-10.
"""

import functools

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu.parallel import batch as jbatch
from emg3d_tpu_torch import models, solver
from emg3d_tpu_torch.parallel import batch as tbatch
from test_torch_batch import CASES, FREQS, N, assert_lanes, problem


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
    ref = jbatch.solve_batch_fields(*problem(e3, epsilon_r=True),
                                    **CASES['plain'])
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

    def run(mod, call):
        model, sfields = problem(mod, zero=(1, 2))
        return call(model, sfields, **kw)

    ref_t = run(t3, functools.partial(t3.solve_batch_fields, device='cpu'))
    assert 'batch shrunk' not in capsys.readouterr().out
    monkeypatch.setenv('EMG3D_TPU_BATCH_SHRINK', '1')
    out_t = run(t3, functools.partial(t3.solve_batch_fields, device='cpu'))
    assert 'batch shrunk to 1/3 lanes' in capsys.readouterr().out
    out_j = run(e3, jbatch.solve_batch_fields)
    assert 'batch shrunk to 1/3 lanes' in capsys.readouterr().out
    assert_lanes(out_t, ref_t, tol=1e-12)
    assert_lanes(out_t, out_j)
    for f in out_t[0][1:]:
        assert np.all(f.field == 0)
