"""The ``line_phase`` CUDA kernel: one 4-color line-relaxation phase.

No TPU kernel is replaced: the JAX package runs the line phase
(``emg3d_tpu.ops.smoothers._line_relax_x_phase`` and ``_block_thomas``)
as XLA ``lax.scan`` loops.  Eager PyTorch would run its block-Thomas as
some 16,000 small launches per phase, so the port runs one phase as one
hand-written kernel, ``csrc/line_phase.cu``.  This module holds its
``ctypes`` wrapper and two plain-integer counters:

- ``LAUNCHES``: kernel launches (one per call of
  :func:`gauss_seidel_line_phase_cuda` whose phase has lines);
- ``PLAIN_CALLS_ON_CUDA``: calls of the plain PyTorch version
  (``smoothers._line_relax_phase_torch``) with CUDA tensors, which only
  comparisons with the kernel make.

The y- and z-lines are the x-lines of a permuted frame
(``FRAMES``).  The kernel reads the untransposed
C-contiguous tensors through the strides of their permuted views, so no
transpose is copied.
"""

import ctypes

import torch

from emg3d_tpu_torch.ops import _build

__all__ = ["gauss_seidel_line_phase_cuda", "LAUNCHES", "PLAIN_CALLS_ON_CUDA",
           "reset_counts", "FRAMES", "SCRATCH_VALUES"]

LAUNCHES = 0
PLAIN_CALLS_ON_CUDA = 0

# Values the kernel keeps per line and group for the backward pass: the
# 5x5 block C_g^{-1} L_{g+1}^T and the 5-vector C_g^{-1} y_g.
SCRATCH_VALUES = 30

# The permuted frame of each line axis: frame axis i is original axis
# FRAMES[axis][i], and the original component FRAMES[axis][i] (of the
# fields, sources, eta and widths) plays the frame's i-th role.
FRAMES = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 1, 0)}

# Entry point per field dtype, and the real dtype of zeta and the widths.
_ENTRY = {
    torch.complex64: ("line_phase_c64", torch.float32),
    torch.complex128: ("line_phase_c128", torch.float64),
    torch.float32: ("line_phase_f32", torch.float32),
    torch.float64: ("line_phase_f64", torch.float64),
}

_FUNCS = {}


def reset_counts():
    """Set both counters to 0."""
    global LAUNCHES, PLAIN_CALLS_ON_CUDA
    LAUNCHES = 0
    PLAIN_CALLS_ON_CUDA = 0


def _func(entry):
    if entry not in _FUNCS:
        fn = getattr(_build.load("line_phase"), entry)
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FUNCS[entry] = fn
    return _FUNCS[entry]


def _check(name, t, device, dtype, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"line_phase: {name} must be a torch.Tensor.")
    if t.device != device:
        raise ValueError(
            f"line_phase: {name} is on {t.device}, expected {device}.")
    if t.dtype != dtype:
        raise TypeError(
            f"line_phase: {name} has dtype {t.dtype}, expected {dtype}.")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"line_phase: {name} has shape {tuple(t.shape)}, expected "
            f"{shape}.")
    if not t.is_contiguous():
        raise ValueError(f"line_phase: {name} must be C-contiguous.")


def _ptr(t):
    return (torch.view_as_real(t) if t.is_complex() else t).data_ptr()


def gauss_seidel_line_phase_cuda(ex, ey, ez, sx, sy, sz, eta_x, eta_y,
                                 eta_z, zeta, hx, hy, hz, p1, p2, axis):
    """Relax the lines along ``axis`` of transverse parity (p1, p2).

    Same arguments and result as ``smoothers._line_relax_phase_torch``:
    updates ``ex``, ``ey``, ``ez`` IN PLACE and returns them.  Every
    tensor must lie on one CUDA device and be C-contiguous; fields,
    sources and eta share one dtype (complex64, complex128, float32 or
    float64), zeta and the widths are real of the same precision.
    Raises on anything else, on a failed build and on a failed launch.
    """
    global LAUNCHES
    device = ex.device
    if device.type != "cuda":
        raise ValueError(
            f"line_phase: tensors must be on a CUDA device, got {device}.")
    if ex.dtype not in _ENTRY:
        raise TypeError(
            f"line_phase: unsupported field dtype {ex.dtype}; expected one "
            f"of {list(_ENTRY)}.")
    if axis not in FRAMES:
        raise ValueError(f"line_phase: axis must be 0, 1, or 2; got {axis}.")
    entry, rdt = _ENTRY[ex.dtype]
    for name, t in (("hx", hx), ("hy", hy), ("hz", hz)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"line_phase: {name} must be a 1-D tensor.")
    nx, ny, nz = hx.numel(), hy.numel(), hz.numel()
    if min(nx, ny, nz) < 2 or p1 not in (0, 1) or p2 not in (0, 1):
        raise ValueError(
            f"line_phase: need >= 2 cells per axis and parities in "
            f"{{0, 1}}; got cells {(nx, ny, nz)}, parity {(p1, p2)}.")
    shx, shy, shz = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                     (nx + 1, ny + 1, nz))
    cell = (nx, ny, nz)
    for name, t, shape, dt in (
            ("ex", ex, shx, ex.dtype), ("ey", ey, shy, ex.dtype),
            ("ez", ez, shz, ex.dtype), ("sx", sx, shx, ex.dtype),
            ("sy", sy, shy, ex.dtype), ("sz", sz, shz, ex.dtype),
            ("eta_x", eta_x, cell, ex.dtype),
            ("eta_y", eta_y, cell, ex.dtype),
            ("eta_z", eta_z, cell, ex.dtype), ("zeta", zeta, cell, rdt),
            ("hx", hx, (nx,), rdt), ("hy", hy, (ny,), rdt),
            ("hz", hz, (nz,), rdt)):
        _check(name, t, device, dt, shape)

    # The frame: lines along frame x, of NX cells; the transverse frame
    # axes y and z carry the parities (p1, p2).
    tp = FRAMES[axis]
    e, s = (ex, ey, ez), (sx, sy, sz)
    eta, h = (eta_x, eta_y, eta_z), (hx, hy, hz)
    fe, fs = [e[r] for r in tp], [s[r] for r in tp]
    feta, fh = [eta[r] for r in tp], [h[r] for r in tp]
    NX, NY, NZ = (t.numel() for t in fh)
    nlines = ((NY - p1) // 2) * ((NZ - p2) // 2)
    if nlines == 0:
        return ex, ey, ez          # Empty phase: no launch of 0 blocks.

    # Strides (in elements) of the permuted views: frame edge arrays of
    # the x, y and z role, then the cell arrays.
    strides = [st for t in (*fe, zeta) for st in t.permute(tp).stride()]
    geo = (ctypes.c_int64 * 15)(NX, NY, NZ, *strides)
    scratch = torch.empty(max(NX - 1, 1) * SCRATCH_VALUES * nlines,
                          dtype=ex.dtype, device=device)

    fn = _func(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(_ptr(t) for t in (*fe, *fs, *feta, zeta, *fh, scratch)),
                 ctypes.addressof(geo), p1, p2, stream)
    if err != 0:
        raise RuntimeError(
            f"line_phase: kernel launch failed with cudaError {err} "
            f"(cells {(nx, ny, nz)}, axis {axis}, parity {(p1, p2)}, "
            f"{ex.dtype}).")
    LAUNCHES += 1
    return ex, ey, ez
