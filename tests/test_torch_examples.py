"""PyTorch port, the examples (``examples/torch_0N_*.py``).

- Each example imports, and its ``main`` is there, in a process where
  neither ``jax`` nor ``emg3d_tpu`` can be imported.
- ``torch_03_transient_fullspace.py --cpu`` (the layered engine, seconds)
  returns the transient of ``03_transient_fullspace.py``, whose calls
  with the JAX package (``jax_transient``) are read from
  tests/data/torch_reference.npz (written by
  tests/create_data/torch_reference.py from the JAX package), to 1e-8;
  its error against the closed form is the one that example prints.  The
  port's DLF filters (cached per process, and dependent on the BLAS
  threads they were designed with) are designed anew on this module's
  one thread, as the JAX package's were for the file.
The other two examples solve in 3-D on the card (``chip_smoke.py`` runs
them there).
"""

import contextlib
import importlib.util
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_allclose

import alternatives
import emg3d_tpu as e3
from emg3d_tpu import layered
from emg3d_tpu_torch import transforms as t_transforms
from torch_reference import reference

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (ROOT / 'examples').glob('torch_0*.py'))


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name[:-3], ROOT / 'examples' / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_three_examples():
    assert EXAMPLES == ['torch_01_marine_csem_forward.py',
                        'torch_02_gradient_and_sensitivities.py',
                        'torch_03_transient_fullspace.py']


@pytest.mark.parametrize('name', EXAMPLES)
def test_example_imports_without_jax(name):
    code = ("import importlib.util, sys\n"
            "for name in ('jax', 'emg3d_tpu'):\n"
            "    sys.modules[name] = None\n"
            "spec = importlib.util.spec_from_file_location(\n"
            f"    'example', 'examples/{name}')\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "assert callable(mod.main)\n"
            "bad = [m for m in sys.modules if sys.modules[m] and ("
            "m.split('.')[0] == 'emg3d_tpu' or m.startswith('jax'))]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == '[]'


# (times, offset, resistivity) of examples/03_transient_fullspace.py.
TRANSIENT = (np.logspace(-2, 1, 13), 900.0, 1.0)


def jax_transient(times, offset, res):
    """The calls of examples/03_transient_fullspace.py, with the JAX
    package: the transient at ``offset`` in a fullspace of ``res``."""
    fourier = e3.Fourier(time=times, fmin=1e-3, fmax=1e2, signal=-1,
                         verb=0)
    fresp = np.array([
        layered.dipole_layered((0, 0, 0, 0, 0), [(offset, 0, 0, 0, 0)],
                               [], [res], f)[0]
        for f in fourier.freq_compute])
    return np.asarray(fourier.freq2time(fresp, offset)).ravel()


def test_transient_example_equals_jax_example():
    t_transforms.design_filter.cache_clear()
    t_transforms.design_hankel_filter.cache_clear()
    example = load_example('torch_03_transient_fullspace.py')
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = example.main(['--cpu'])

    times, offset, res = TRANSIENT
    ref = reference('examples.transient', *TRANSIENT)['transient']
    exact = alternatives.fullspace_dipole_time(
        np.array([[offset, 0., 0.]]), (0., 0., 0.), times, res,
        signal=-1)[:, 0, 0]

    assert_allclose(out['times'], times)
    assert np.all(np.isfinite(out['computed']))
    assert_allclose(out['computed'], ref, rtol=1e-8,
                    atol=1e-8 * np.abs(ref).max())
    assert_allclose(out['exact'], exact, rtol=1e-15)
    assert_allclose(out['error'], np.abs(ref - exact) / np.abs(exact),
                    rtol=1e-6)
    lines = printed.getvalue().splitlines()
    assert any(line.startswith('278 required frequencies, 128 to compute')
               for line in lines)
    assert lines[-14].split() == ['t', '[s]', 'E', 'computed', 'E',
                                  'exact', 'err']
