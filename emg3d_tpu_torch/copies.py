"""Every field and array that crosses between the host and the device.

The solve path, the batch engine and ``fields.get_magnetic_field`` copy
through this module alone, which counts every copy (:mod:`tracing`'s
``h2d_*``, ``d2h_*`` and ``host_syncs``), except those of a grid-sharded
finest level (``parallel.domain.place_field``).  A host ``Field`` holds
its components as Fortran-ordered views of one array; on the device a
field is three C-contiguous tensors, with a leading lane axis in the
batch engine.

Dtype rule: a field changes dtype on the host, on its way in before its
copy (as PyTorch converts a host-to-device copy) and on its way out as it
is written into the ``Field``.  The one exception is a split iterate
``e_hi + e_lo``, summed on the device in the ``Field``'s dtype, so that
the accuracy the two parts carry survives the export.  Sources and
Krylov vectors are complex128 (float64 in the Laplace domain), so only a
stand-alone multigrid solve in single precision converts a field on its
way in.
"""

import numpy as np
import torch

from emg3d_tpu_torch import tracing

__all__ = ['to_device', 'to_host', 'scalar', 'field_to_device',
           'field_to_host']

COMPONENTS = ('fx', 'fy', 'fz')


def _host(a):
    """A host array (or host tensor) as a C-contiguous host tensor."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return a


def _dtype(field):
    """The torch dtype of a host ``Field``."""
    return torch.from_numpy(field.field[:0]).dtype


def _h2d(t):
    """Count the copy of device tensor ``t``; returns it."""
    tracing.count('h2d_bytes', t.numel() * t.element_size())
    tracing.count('h2d_copies')
    return t


def to_device(a, device, dtype=None):
    """A host array (or host tensor) as a C-contiguous tensor of ``dtype``
    on ``device``; counts ``h2d_bytes`` (of the device tensor) and
    ``h2d_copies``."""
    return _h2d(_host(a).to(device=device, dtype=dtype))


def to_host(t):
    """A device tensor (or the Pieces of a sharded one) as a host NumPy
    array; counts ``d2h_bytes`` and ``d2h_copies``."""
    h = t.cpu()
    tracing.count('d2h_bytes', h.numel() * h.element_size())
    tracing.count('d2h_copies')
    return h.numpy()


def scalar(t):
    """A host read of device values, in an ``emg3d.sync`` span; counts
    ``host_syncs``.  A 0-d tensor gives a float (a complex for a complex
    tensor), any other a NumPy array."""
    with tracing.span('emg3d.sync'):
        tracing.count('host_syncs')
        a = to_host(t)
    return a.item() if a.ndim == 0 else a


def field_to_device(fields, device, dtype=None, layout=None):
    """Host ``Field``\\ s -> device tensors (fx, fy, fz) of ``dtype``
    (None: the Field's own).

    A ``Field`` gives three tensors of its components' shapes; a
    sequence of Fields three tensors with a leading lane axis, lane k
    copied from ``fields[k]`` (no transient beyond the result).
    ``layout`` (a sharded finest level) places a Field's components as
    the Pieces of that layout on its devices.
    """
    with tracing.span('emg3d.fields.to_device'):
        if layout is not None:
            from emg3d_tpu_torch.parallel import domain
            return domain.place_field(
                layout, [getattr(fields, c) for c in COMPONENTS], dtype)
        lanes = isinstance(fields, (list, tuple))
        fields = fields if lanes else [fields]
        dtype = _dtype(fields[0]) if dtype is None else dtype
        out = tuple(torch.empty((len(fields), *getattr(fields[0], c).shape),
                                dtype=dtype, device=device)
                    for c in COMPONENTS)
        for k, f in enumerate(fields):
            for dst, c in zip(out, COMPONENTS):
                _h2d(dst[k].copy_(_host(getattr(f, c)).to(dtype)))
        return out if lanes else tuple(t[0] for t in out)


def field_to_host(e, out, lo=None):
    """Write device tensors ``e`` (fx, fy, fz) into the host ``Field``
    ``out`` in place, in ``out``'s dtype.

    With ``lo`` the field is the split iterate ``e + lo``, summed on the
    device in ``out``'s dtype first.  With a leading lane axis ``out`` is
    a sequence of Fields, lane k written into ``out[k]``; a None lane (a
    padding lane) is not written, and lanes that are all padding are
    not copied.  Each component is one copy to the host and one write
    into the Fortran-ordered view of each Field.
    """
    lanes = isinstance(out, (list, tuple))
    out = out if lanes else [out]
    first = next((f for f in out if f is not None), None)
    if first is None:
        return
    with tracing.span('emg3d.fields.to_host'):
        dtype = _dtype(first)
        for i, c in enumerate(COMPONENTS):
            t = e[i] if lo is None else e[i].to(dtype) + lo[i].to(dtype)
            h = to_host(t)
            for f, part in zip(out, h if lanes else [h]):
                if f is not None:
                    getattr(f, c)[...] = part
