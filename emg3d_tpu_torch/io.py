"""Save/load framework instances to/from h5, npz, and json.

Copy of ``emg3d_tpu.io`` for the PyTorch port (numpy and scipy
only; the text below speaks of the JAX package it was written for).
Rebuild of the reference's emg3d/io.py:41-632: recursive serialization of
all registered classes (meshes, models, fields, electrodes, surveys,
simulations) via their ``to_dict``/``from_dict`` methods, plus metadata
(date, version, format).
"""

import json
import os
import warnings
from datetime import datetime

import numpy as np

from emg3d_tpu_torch import utils

__all__ = ["save", "load", "convert"]


def __dir__():
    return __all__


def save(fname, **kwargs):
    """Save any number of class instances and arrays to disk.

    Extension decides the backend: '.h5' (requires h5py), '.npz', '.json'
    (reference io.py:41-130).
    """
    verb = kwargs.pop("verb", 0)
    json_indent = kwargs.pop("json_indent", 2)

    data = _dict_serialize(kwargs)
    data["_date"] = datetime.today().isoformat()
    data["_version"] = "emg3d_tpu_torch v" + utils.__version__
    data["_format"] = "0.1"

    ext = os.path.splitext(fname)[1].lower()
    if ext == ".h5":
        try:
            import h5py
        except ImportError:
            raise ImportError("Saving to '.h5' requires h5py.")
        with h5py.File(fname, "w") as h5file:
            _hdf5_dump(h5file, data)
    elif ext == ".npz":
        np.savez_compressed(fname, **_dict_flatten(data))
    elif ext == ".json":
        with open(fname, "w") as f:
            json.dump(_dict_dearray(data), f, indent=json_indent)
    else:
        raise ValueError(f"Unknown extension '{ext}'.")

    info = (f"Data saved to «{fname}»\n[{data['_version']} "
            f"(format {data['_format']}) on {data['_date']}]")
    if verb > 0:
        print(info)
    elif verb < 0:
        return info


def load(fname, **kwargs):
    """Load data saved with :func:`save`.

    Returns a dict; registered class dicts are re-instantiated
    (reference io.py:133-235).
    """
    verb = kwargs.pop("verb", 0)
    data, info = _read(fname)
    data = _dict_deserialize(data)
    if verb > 0:
        print(info)
    elif verb < 0:
        return data, info
    return data


def _read(fname):
    """The content of a file written by :func:`save`, with no class
    re-instantiated, and the info string on where it came from."""
    ext = os.path.splitext(fname)[1].lower()
    if ext == ".h5":
        try:
            import h5py
        except ImportError:
            raise ImportError("Loading '.h5' requires h5py.")
        with h5py.File(fname, "r") as h5file:
            data = _hdf5_load(h5file)
    elif ext == ".npz":
        with np.load(fname, allow_pickle=False) as npz:
            data = _dict_unflatten({k: npz[k] for k in npz.files})
    elif ext == ".json":
        with open(fname, "r") as f:
            data = _dict_rearray(json.load(f))
    else:
        raise ValueError(f"Unknown extension '{ext}'.")

    version = data.pop("_version", "unknown version")
    date = data.pop("_date", "unknown date")
    fformat = data.pop("_format", "unknown format")
    info = (f"Data loaded from «{fname}»\n[{version} "
            f"(format {fformat}) on {date}]")
    return data, info


def convert(data_or_file, classname, **kwargs):
    """Convert a dict/file content into an instance of ``classname``."""
    if isinstance(data_or_file, str):
        data = load(data_or_file, **kwargs)
    else:
        data = _dict_deserialize(_dict_serialize(data_or_file))
    cls = utils._KNOWN_CLASSES[classname]
    if isinstance(data, dict) and data.get("__class__") == classname:
        return cls.from_dict(data)
    return data


# --------------------------------------------------------------------------
# Recursive (de)serialization.
# --------------------------------------------------------------------------

def _dict_serialize(data):
    """Recursively convert known class instances to plain dicts."""
    out = {}
    for key, value in data.items():
        name = value.__class__.__name__
        if name in utils._KNOWN_CLASSES and hasattr(value, "to_dict"):
            out[key] = _dict_serialize_one(value.to_dict())
        elif isinstance(value, dict):
            out[key] = _dict_serialize(value)
        else:
            out[key] = value
    return out


def _dict_serialize_one(d):
    """Serialize nested instances inside one to_dict output."""
    out = {}
    for key, value in d.items():
        name = value.__class__.__name__
        if name in utils._KNOWN_CLASSES and hasattr(value, "to_dict"):
            out[key] = _dict_serialize_one(value.to_dict())
        elif isinstance(value, dict):
            out[key] = _dict_serialize_one(value)
        else:
            out[key] = value
    return out


def _dict_deserialize(data):
    """Recursively instantiate registered classes from dicts."""
    if isinstance(data, dict):
        data = {k: _dict_deserialize(v) for k, v in data.items()}
        cls = data.get("__class__", None)
        if isinstance(cls, (bytes, np.bytes_)):
            cls = cls.decode()
        if isinstance(cls, np.ndarray):
            cls = str(cls.item()) if cls.size == 1 else None
        if cls in utils._KNOWN_CLASSES:
            try:
                return utils._KNOWN_CLASSES[cls].from_dict(data)
            except (TypeError, ValueError, KeyError) as e:
                warnings.warn(
                    f"Could not deserialize <{cls}>: {e}", UserWarning)
    return data


# --------------------------------------------------------------------------
# npz helpers: flatten nested dicts to 'a>b>c' keys.
# --------------------------------------------------------------------------

def _dict_flatten(data, prefix=""):
    out = {}
    for key, value in data.items():
        full = f"{prefix}>{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(_dict_flatten(value, full))
        elif value is None:
            out[full] = np.array("__None__")
        else:
            out[full] = np.asarray(value)
    return out


def _dict_unflatten(flat):
    out = {}
    for key, value in flat.items():
        parts = key.split(">")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        if value.dtype.kind in "US" and value.size == 1 \
                and str(value.item() if value.ndim == 0 else value[0]) \
                == "__None__":
            d[parts[-1]] = None
        elif value.ndim == 0:
            item = value.item()
            d[parts[-1]] = item
        else:
            d[parts[-1]] = value
    return out


# --------------------------------------------------------------------------
# json helpers: arrays <-> lists with dtype tags.
# --------------------------------------------------------------------------

def _dict_dearray(data):
    out = {}
    for key, value in data.items():
        if isinstance(value, dict):
            out[key] = _dict_dearray(value)
        elif isinstance(value, np.ndarray):
            if np.iscomplexobj(value):
                out[key + "__complex"] = np.stack(
                    [value.real, value.imag]).tolist()
            else:
                out[key + "__array-" + str(value.dtype)] = value.tolist()
        elif isinstance(value, complex):
            out[key + "__complex"] = [value.real, value.imag]
        elif isinstance(value, (np.integer, np.floating, np.bool_)):
            out[key] = value.item()
        else:
            out[key] = value
    return out


def _dict_rearray(data):
    out = {}
    for key, value in data.items():
        if isinstance(value, dict):
            out[key] = _dict_rearray(value)
        elif key.endswith("__complex"):
            arr = np.asarray(value)
            out[key[:-9]] = arr[0] + 1j * arr[1] if arr.ndim > 1 else \
                complex(arr[0], arr[1])
        elif "__array-" in key:
            name, dtype = key.split("__array-")
            out[name] = np.asarray(value, dtype=dtype)
        else:
            out[key] = value
    return out


# --------------------------------------------------------------------------
# hdf5 helpers.
# --------------------------------------------------------------------------

def _hdf5_dump(h5file, data):
    for key, value in data.items():
        if isinstance(value, dict):
            _hdf5_dump(h5file.create_group(key), value)
        elif value is None:
            h5file[key] = "__None__"
        elif isinstance(value, str):
            h5file[key] = value
        else:
            h5file[key] = np.asarray(value)


def _hdf5_load(h5file):
    out = {}
    for key, value in h5file.items():
        if hasattr(value, "items"):
            out[key] = _hdf5_load(value)
        else:
            arr = value[()]
            if isinstance(arr, bytes):
                arr = arr.decode()
            if isinstance(arr, str) and arr == "__None__":
                arr = None
            out[key] = arr
    return out
