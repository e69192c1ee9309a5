"""The JAX package's answers to the port's parity tests, read from a file.

``tests/data/torch_reference.npz`` holds, for every case of
``tests/create_data/torch_reference.py``, what the JAX package computed on
the inputs that the port's test builds, beside a SHA-256 digest of those
inputs.  A test asks for its case with the inputs it built:
``reference(case, *inputs)`` returns the stored values when the digest
matches, and fails, naming the generator, when an input changed or the
case is missing; a changed input is never held against a stale answer.
``tests/test_torch_reference_data.py`` (marked slow) computes every case
anew with the JAX package and holds the file against it.

Keys of the file are ``case>name`` (``case>a>b`` for nested dicts), and
``case>__digest__``; ``None`` is stored as the string ``'__None__'``.  In
the file, a case's scalars are one JSON string under ``case>__scalars__``
(a member each would cost more than its value), and an array equal to
one stored under an earlier key is the string ``'__same_as__ <key>'``.
"""

import collections
import functools
import hashlib
import json
import os

import numpy as np
import torch

FNAME = os.path.join(os.path.dirname(__file__), 'data',
                     'torch_reference.npz')
GENERATOR = 'python tests/create_data/torch_reference.py'
DIGEST = '__digest__'
NONE = '__None__'
SAME = '__same_as__ '
SCALARS = '__scalars__'


# A stored field, read as the tests read a Field: ``.field``.
Field = collections.namedtuple('Field', 'field')


class StaleReference(AssertionError):
    """The file has no answer for these inputs."""


def digest(*inputs):
    """SHA-256 of ``inputs``: the bytes, dtype and shape of every array;
    strings, numbers and ``None``; dicts (by sorted key), lists and
    tuples recursively; objects of either package by their ``to_dict``."""
    h = hashlib.sha256()
    _feed(h, inputs)
    return h.hexdigest()


def _feed(h, obj):
    if isinstance(obj, dict):
        h.update(b'{')
        for key in sorted(obj, key=str):
            _feed(h, str(key))
            _feed(h, obj[key])
        h.update(b'}')
    elif isinstance(obj, (list, tuple)):
        h.update(b'[')
        for item in obj:
            _feed(h, item)
        h.update(b']')
    elif isinstance(obj, str):
        h.update(b's' + obj.encode() + b'\0')
    elif obj is None:
        h.update(b'N')
    elif isinstance(obj, torch.dtype):
        _feed(h, str(obj))
    elif isinstance(obj, torch.Tensor):
        _feed(h, obj.detach().cpu().numpy())
    elif hasattr(obj, 'to_dict'):
        _feed(h, obj.to_dict())
    else:
        arr = np.ascontiguousarray(np.asarray(obj))
        if arr.dtype.kind == 'O':
            raise TypeError(f"Cannot digest {type(obj).__name__}.")
        if arr.dtype.kind == 'U':
            _feed(h, arr.tolist())
            return
        h.update(f'a{arr.dtype.str}{arr.shape}'.encode())
        h.update(arr.tobytes())


def masked(arrays, before=None):
    """``arrays`` as stored values ``{'0': a0, '1': a1, ...}``; with
    ``before``, an entry equal to its entry in ``before`` (what a
    smoothing phase left as it was) is stored as NaN, which compresses to
    nothing."""
    if before is not None:
        arrays = [np.where(a == b, np.nan, a)
                  for a, b in zip(arrays, before)]
    return {str(k): a for k, a in enumerate(arrays)}


def fields(values, before=None):
    """The arrays that ``masked(arrays, before)`` stored, as a list."""
    arrays = [values[str(k)] for k in range(len(values))]
    if before is not None:
        arrays = [np.where(np.isnan(a), b, a)
                  for a, b in zip(arrays, before)]
    return arrays


def flatten(values, prefix):
    """``values`` (nested dicts) as flat ``prefix>...`` keys of arrays."""
    out = {}
    for key, val in values.items():
        full = f'{prefix}>{key}'
        if isinstance(val, dict):
            out.update(flatten(val, full))
        elif val is None:
            out[full] = np.asarray(NONE)
        else:
            out[full] = np.asarray(val)
    return out


def unflatten(flat, prefix):
    """The nested dict under ``prefix``; 0-d arrays as Python scalars."""
    out = {}
    start = prefix + '>'
    for key, val in flat.items():
        if not key.startswith(start):
            continue
        parts = key[len(start):].split('>')
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if val.ndim == 0:
            val = val.item()
            if val == NONE:
                val = None
        node[parts[-1]] = val
    return out


@functools.lru_cache(maxsize=None)
def stored(fname=FNAME):
    """Every array of the file, by key (read once per process)."""
    if not os.path.isfile(fname):
        return {}
    with np.load(fname, allow_pickle=False) as npz:
        flat = {key: npz[key] for key in npz.files}
    for key in [k for k in flat if k.endswith('>' + SCALARS)]:
        case = key[:-len(SCALARS) - 1]
        flat.update((f'{case}>{name}', np.asarray(val))
                    for name, val in json.loads(str(flat.pop(key))).items())
    for key, val in flat.items():
        if val.dtype.kind == 'U' and str(val).startswith(SAME):
            flat[key] = flat[str(val)[len(SAME):]]
    return flat


def reference(case, *inputs, fname=FNAME):
    """The stored values of ``case`` if they were computed from
    ``inputs``; else raise ``StaleReference`` naming the generator."""
    flat = stored(fname)
    key = f'{case}>{DIGEST}'
    if key not in flat:
        raise StaleReference(
            f"No case {case!r} in {fname}; write it with `{GENERATOR} "
            f"{case}`.")
    if str(flat[key]) != digest(*inputs):
        raise StaleReference(
            f"The inputs of case {case!r} differ from those its stored "
            f"answer was computed from; write it anew with `{GENERATOR} "
            f"{case}`.")
    values = unflatten(flat, case)
    del values[DIGEST]
    return values
