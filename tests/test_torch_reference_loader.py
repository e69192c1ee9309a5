"""The loader of the JAX answers (tests/torch_reference.py), on a file of
its own: the answer comes back for the inputs it was made from; an input
changed in one element, or a case the file does not hold, fails naming
the generator that writes the file."""

import numpy as np
import pytest

import torch_reference


def inputs():
    rng = np.random.default_rng(5)
    return rng.uniform(1, 2, (4, 3)), {'tol': 1e-6, 'cycle': 'F'}, 'case'


@pytest.mark.parametrize('ask', ['matching', 'changed', 'missing'])
def test_reference(tmp_path, ask):
    fname = str(tmp_path / 'reference.npz')
    values = {'field': np.arange(6.0) + 1j, 'it_mg': 4,
              'info': {'exit_message': 'CONVERGED', 'ref': None}}
    flat = torch_reference.flatten(values, 'one')
    flat['one>' + torch_reference.DIGEST] = np.asarray(
        torch_reference.digest(*inputs()))
    np.savez_compressed(fname, **flat)

    arr, opts, text = inputs()
    if ask == 'matching':
        out = torch_reference.reference('one', arr, opts, text, fname=fname)
        assert set(out) == {'field', 'it_mg', 'info'}
        np.testing.assert_array_equal(out['field'], values['field'])
        assert out['it_mg'] == 4
        assert out['info'] == {'exit_message': 'CONVERGED', 'ref': None}
        return
    case = 'one'
    if ask == 'changed':
        arr[2, 1] = np.nextafter(arr[2, 1], 3.0)
    else:
        case = 'two'
    with pytest.raises(torch_reference.StaleReference,
                       match=torch_reference.GENERATOR + ' ' + case):
        torch_reference.reference(case, arr, opts, text, fname=fname)
