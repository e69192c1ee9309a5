"""PyTorch port, north-star configuration 5 (``northstar.time_domain``) and a
Laplace-domain solve with the default solver.

- ``northstar.time_domain`` at 16^3 on 4 frequencies (``fmin`` 0.85,
  ``fmax`` 1.2 Hz; a 400 m offset, inside the 1.6 km grid) on the CPU,
  against the JAX recipe's calls inline (tools/bench_time.py:63-79:
  ``emg3d_tpu.Fourier``, ``solve_source`` with plain F-cycles,
  ``get_receiver``, ``freq2time``; its answers read from
  tests/data/torch_reference.npz, written by
  tests/create_data/torch_reference.py from the JAX package): the same
  ``it_mg`` per frequency, responses and transient to 1e-10.
- The Laplace-domain problem (``frequency`` < 0, real fields) with the
  solver's default options (MG-preconditioned BiCGSTAB, semicoarsening
  and line relaxation) at 8^3 on the CPU against the dense direct solve
  of tests/alternatives.dense_matrix; and the same solve through the
  whole-cycle step (``EMG3D_TPU_CYCLE_JIT=1``, which on the CPU runs the
  step's body uncaptured) equal to the per-operation solve, the second
  time from the steps the first one made.  The plain
  Laplace solve is held against the JAX package in
  tests/test_torch_regression.py.
- Marked slow (about 18 minutes on one thread): the JAX recipe at its own
  size, 64^3 and 128 frequencies, reproduces the reference numbers that
  chip_smoke.py holds the card's run against (``TIME_DOMAIN_REFERENCE``,
  computed by this test) to 1e-10.  With ``-s`` it prints what it
  computed, its seconds and its error against the closed form.

The DLF filter both packages design (``transforms.design_filter``, cached
per process) depends on the BLAS threads it was designed with (its cosine
weights by 6e-6 between one thread and eight), so each test that compares
transients designs both filters anew on the one thread of this module.
"""

import importlib.util
import pathlib
import time

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_allclose

import alternatives
import emg3d_tpu as e3
from emg3d_tpu_torch import models as t_models
from emg3d_tpu_torch import northstar
from emg3d_tpu_torch import solver as t_solver
from emg3d_tpu_torch import transforms as t_transforms
from torch_reference import reference

BAND = dict(fmin=0.85, fmax=1.2, offset=400.0)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture
def one_thread_filters():
    """Both packages' DLF filters designed anew on this module's one BLAS
    thread, not taken from an earlier test's cache."""
    e3.transforms.design_filter.cache_clear()
    t_transforms.design_filter.cache_clear()


def jax_time_domain(n, times, fmin, fmax, offset):
    """tools/bench_time.py's recipe (lines 63-79) with the JAX package:
    the transient, and per frequency the response and ``it_mg``."""
    fourier = e3.Fourier(time=times, fmin=fmin, fmax=fmax, signal=-1,
                         verb=0)
    h = np.full(n, 100.0)
    grid = e3.TensorMesh([h, h, h], origin=(-n * 50.0,) * 3)
    model = e3.Model(grid, property_x=1.0)
    fresp, its = [], []
    for f in fourier.freq_compute:
        efield, info = e3.solve_source(
            model, (0., 0., 0., 0., 0.), f, plain=True, cycle='F',
            tol=1e-6, maxit=50, verb=-1, return_info=True)
        fresp.append(complex(e3.fields.get_receiver(
            efield, (offset, 0., 0., 0., 0.))))
        its.append(info['it_mg'])
    fresp = np.array(fresp)
    tresp = np.asarray(fourier.freq2time(fresp, offset)).ravel()
    return tresp, fresp, its, np.asarray(fourier.freq_compute)


def test_time_domain_equals_jax_recipe(one_thread_filters):
    times = np.logspace(-2, 1, 13)
    transient, per_freq = northstar.time_domain(16, times=times,
                                                device='cpu', **BAND)
    # jax_time_domain(16, times, **BAND), its filter designed on one thread.
    ref = reference('time_domain.16', 16, times, BAND)
    ref_t, ref_resp, freqs = ref['transient'], ref['responses'], ref['freqs']
    ref_its = ref['it_mg'].tolist()

    assert len(per_freq) == freqs.size == 4
    assert_allclose([p['frequency'] for p in per_freq], freqs, rtol=1e-15)
    assert [p['exit_message'] for p in per_freq] == ['CONVERGED'] * 4
    assert all(p['rel_error'] < 1e-6 and p['seconds'] > 0
               for p in per_freq)
    assert [p['it_mg'] for p in per_freq] == ref_its
    resp = np.array([p['response'] for p in per_freq])
    assert np.all(np.isfinite(resp))
    assert_allclose(resp, ref_resp, rtol=1e-10,
                    atol=1e-10 * np.abs(ref_resp).max())
    assert transient.shape == times.shape
    assert_allclose(transient, ref_t, rtol=1e-10,
                    atol=1e-10 * np.abs(ref_t).max())


@pytest.mark.slow
def test_time_domain_64_reference(one_thread_filters):
    spec = importlib.util.spec_from_file_location(
        'chip_smoke',
        pathlib.Path(__file__).resolve().parent.parent / 'chip_smoke.py')
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ref = chip_smoke.TIME_DOMAIN_REFERENCE

    times, offset = np.logspace(-2, 1, 13), 900.0
    t0 = time.perf_counter()
    tresp, _, its, freqs = jax_time_domain(
        64, times, fmin=1e-3, fmax=1e2, offset=offset)
    seconds = time.perf_counter() - t0
    exact = alternatives.fullspace_dipole_time(
        np.array([[offset, 0., 0.]]), (0., 0., 0.), times, 1.0,
        signal=-1)[:, 0, 0]
    err = np.abs(tresp - exact) / np.abs(exact)
    print(f"\nJAX recipe 64^3, {freqs.size} frequencies: {seconds:.1f} s; "
          f"transient {tresp.tolist()}; it_mg {chip_smoke.run_lengths(its)}; "
          f"relative error against the closed form {err.tolist()}, largest "
          f"over the core (times 1-9) {err[1:10].max()!r}; largest "
          f"relative difference from TIME_DOMAIN_REFERENCE "
          f"{np.max(np.abs(tresp / ref['transient'] - 1))!r}")
    assert freqs.size == 128
    assert chip_smoke.run_lengths(its) == ref['it_mg']
    assert_allclose(tresp, ref['transient'], rtol=1e-10)


def test_laplace_default_solver_dense():
    """``northstar.laplace_problem`` at 8^3 (50 m cells, rho 1/2/5 Ohm m,
    s = 1/s) with the default solver: real fields, converged, and equal
    to the dense direct solve on the interior edges."""
    model, sfield = northstar.laplace_problem(8)
    assert sfield.field.dtype == np.float64
    efield, info = t_solver.solve(model, sfield, tol=1e-8,
                                  return_info=True, device='cpu')
    assert info['exit_message'] == 'CONVERGED'
    assert info['it_ssl'] > 0 and info['it_mg'] > 0
    assert efield.field.dtype == np.float64

    grid = model.grid
    vmodel = t_models.VolumeModel(model, sfield)
    A = alternatives.dense_matrix(grid, vmodel, dtype=np.float64)
    mask = alternatives.interior_mask(grid)
    b = alternatives.field_to_cvec(sfield)
    e = alternatives.field_to_cvec(efield)
    x = np.zeros_like(b)
    x[mask] = np.linalg.solve(A[np.ix_(mask, mask)], b[mask])
    err = np.linalg.norm(e[mask] - x[mask]) / np.linalg.norm(x[mask])
    assert err < 1e-6


def test_laplace_whole_cycle_step_equals_per_operation(monkeypatch):
    """The Laplace default solve through the whole-cycle step (real
    working dtypes, steps of their own) equals the per-operation solve
    bit for bit, with the same iterations; a second solve makes no new
    step and runs every cycle from the first one's."""
    problem = northstar.laplace_problem(8)
    t_solver._STEPS.clear()
    runs = []
    for mode in ('0', '1', '1'):
        monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', mode)
        t_solver.reset_counts()
        efield, info = t_solver.solve(*problem, tol=1e-6, return_info=True,
                                      device='cpu')
        runs.append((efield.field, info, t_solver.CYCLE_CAPTURES,
                     t_solver.CYCLE_REPLAYS))
    (f0, i0, c0, r0), (f1, i1, c1, _), (f2, i2, c2, r2) = runs
    assert c0 == r0 == 0
    assert c1 > 0 and c2 == 0 and r2 == i2['it_mg']
    for field, info in ((f1, i1), (f2, i2)):
        for key in ('it_ssl', 'it_mg', 'exit_message'):
            assert info[key] == i0[key]
        assert field.dtype == np.float64
        assert np.array_equal(field, f0)
