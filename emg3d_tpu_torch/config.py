"""Numeric configuration of the PyTorch port: device and working dtype.

Host containers (``Field``, ``Model``) are always float64/complex128, as in
``emg3d_tpu``.  Only device tensors carry the working precision, which the
port derives from the device the solve runs on:

- CUDA: complex64/float32 smoothing, with the residual evaluated in native
  complex128/float64 (Hopper has FP64, so no double-single arithmetic);
- CPU: complex128/float64 throughout (the parity configuration the tests
  hold against the JAX package in x64 mode).

An explicit ``dtype`` overrides the device default (e.g. complex128 on
CUDA, to check the kernel tightly).

Reference: dtype selection in emg3d/fields.py:93-107 (frequency>0 ->
complex, frequency<0 [Laplace] -> real).
"""

import numpy as np
import torch

__all__ = ["resolve_device", "working_dtypes", "dtype_name", "solve_dtype"]


def resolve_device(device=None):
    """The ``torch.device`` of a solve (default: the CUDA card).

    ``device=None`` means ``cuda``: the port runs on the card unless the
    caller asks for the CPU (``device='cpu'``, as the tests do).  Asking
    for CUDA, or giving no device, on a host without a card raises:
    nothing falls back to the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device} requested (no device means the card), but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU.")
    return device


_WORKING_DTYPES = {
    "complex64": torch.complex64, "complex128": torch.complex128,
    "float32": torch.float32, "float64": torch.float64,
}


def dtype_name(dtype):
    """The name ('complex64', ...) of a working dtype given as a torch
    dtype or as its name, with or without ``torch.`` in front; the form
    in which a dtype is stored to a file."""
    name = str(dtype).removeprefix("torch.")
    if name not in _WORKING_DTYPES:
        raise ValueError(f"Unsupported working dtype {dtype}.")
    return name


def working_dtypes(device, is_complex, dtype=None):
    """(field dtype, real dtype) of the device tensors of a solve.

    ``dtype`` (a torch complex or real dtype or its name, or None)
    overrides the device default; its precision sets both entries.
    """
    if dtype is None:
        double = device.type != "cuda"
    else:
        double = dtype_name(dtype) in ("complex128", "float64")
    rdt = torch.float64 if double else torch.float32
    cdt = torch.complex128 if double else torch.complex64
    return (cdt if is_complex else rdt), rdt


def solve_dtype(frequency):
    """HOST Field dtype given the frequency convention of the reference.

    - ``frequency > 0``: frequency domain, s = i*2*pi*f -> complex dtype;
    - ``frequency < 0``: Laplace domain, s = -frequency (real) -> real dtype;
    - ``frequency is None``: frequency-independent source vector -> real.

    Mirrors emg3d/fields.py:93-102.  Host-side containers (Field, Model)
    are ALWAYS float64/complex128; only device tensors carry the working
    precision (:func:`working_dtypes`).
    """
    if frequency is None:
        return np.float64
    if frequency > 0:
        return np.complex128
    if frequency < 0:
        return np.float64
    raise ValueError(
        "`frequency` must be f>0 (frequency domain) or f<0 (Laplace domain). "
        f"Provided: {frequency} Hz."
    )
