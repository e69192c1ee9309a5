"""The JAX answers of tests/data/torch_reference.npz against the JAX package.

The port's parity tests read what the JAX package computed on their
inputs from that file.  Here every case of
tests/create_data/torch_reference.py runs through the JAX package anew,
on the inputs the tests build today: the digest of those inputs equals
the stored one, and every stored value equals the new one, numbers to
rtol 1e-13 of the largest entry, integers, strings and flags exactly.
Marked slow: it runs the JAX compiles that the parity tests no longer
run (about an hour of one worker); ``-m slow`` runs it.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import torch_reference

_spec = importlib.util.spec_from_file_location(
    'torch_reference_generator', pathlib.Path(__file__).resolve().parent
    / 'create_data' / 'torch_reference.py')
generator = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(generator)


def assert_same(got, want, key):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), key
        for name in want:
            assert_same(got[name], want[name], f'{key}>{name}')
    elif np.asarray(want).dtype.kind in 'fc':
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, key
        np.testing.assert_allclose(
            got, want, rtol=1e-13, err_msg=key,
            atol=1e-13 * (np.nanmax(np.abs(want)) if want.size else 0))
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.slow
@pytest.mark.parametrize('name', list(generator.CASES))
def test_stored_case_equals_jax_now(name):
    fresh = torch_reference.unflatten(generator.compute(name), name)
    assert_same(fresh, torch_reference.unflatten(torch_reference.stored(),
                                                 name), name)
