"""The ``gs_phase`` CUDA kernel: one 8-color point Gauss-Seidel phase.

Counterpart of ``emg3d_tpu.ops.pallas_gs``: the hand-written Hopper
kernel ``csrc/gs_phase.cu`` replaces both Pallas kernels there (the
whole-phase and the tiled form compute the same function).  This module
holds its ``ctypes`` wrapper and two plain-integer counters:

- ``LAUNCHES``: kernel launches (one per call of
  :func:`gauss_seidel_phase_cuda` whose phase has nodes);
- ``PLAIN_CALLS_ON_CUDA``: calls of the plain PyTorch version
  (``smoothers._gauss_seidel_phase_torch``) with CUDA tensors, which only
  comparisons with the kernel make.

The plain version is ``emg3d_tpu_torch.ops.smoothers._gauss_seidel_phase_torch``.
"""

import ctypes

import torch

from emg3d_tpu_torch.ops import _build

__all__ = ["gauss_seidel_phase_cuda", "LAUNCHES", "PLAIN_CALLS_ON_CUDA",
           "reset_counts"]

LAUNCHES = 0
PLAIN_CALLS_ON_CUDA = 0

# Entry point per field dtype, and the real dtype of zeta and the widths.
_ENTRY = {
    torch.complex64: ("gs_phase_c64", torch.float32),
    torch.complex128: ("gs_phase_c128", torch.float64),
    torch.float32: ("gs_phase_f32", torch.float32),
    torch.float64: ("gs_phase_f64", torch.float64),
}

_FUNCS = {}


def reset_counts():
    """Set both counters to 0."""
    global LAUNCHES, PLAIN_CALLS_ON_CUDA
    LAUNCHES = 0
    PLAIN_CALLS_ON_CUDA = 0


def _func(entry):
    if entry not in _FUNCS:
        fn = getattr(_build.load("gs_phase"), entry)
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int64] * 3
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FUNCS[entry] = fn
    return _FUNCS[entry]


def _check(name, t, device, dtype, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"gs_phase: {name} must be a torch.Tensor.")
    if t.device != device:
        raise ValueError(
            f"gs_phase: {name} is on {t.device}, expected {device}.")
    if t.dtype != dtype:
        raise TypeError(
            f"gs_phase: {name} has dtype {t.dtype}, expected {dtype}.")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"gs_phase: {name} has shape {tuple(t.shape)}, expected "
            f"{shape}.")
    if not t.is_contiguous():
        raise ValueError(f"gs_phase: {name} must be C-contiguous.")


def _ptr(t):
    return (torch.view_as_real(t) if t.is_complex() else t).data_ptr()


def gauss_seidel_phase_cuda(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                            zeta, hx, hy, hz, px, py, pz):
    """Relax the interior nodes of parity (px, py, pz) with the kernel.

    Same arguments and result as
    ``smoothers._gauss_seidel_phase_torch``: updates ``ex``, ``ey``,
    ``ez`` IN PLACE and returns them.  Every tensor must lie on one CUDA
    device and be C-contiguous; fields, sources and eta share one dtype
    (complex64, complex128, float32 or float64), zeta and the widths
    are real of the same precision.  Raises on anything else, on a
    failed build and on a failed launch.
    """
    global LAUNCHES
    device = ex.device
    if device.type != "cuda":
        raise ValueError(
            f"gs_phase: tensors must be on a CUDA device, got {device}.")
    if ex.dtype not in _ENTRY:
        raise TypeError(
            f"gs_phase: unsupported field dtype {ex.dtype}; expected one "
            f"of {list(_ENTRY)}.")
    entry, rdt = _ENTRY[ex.dtype]
    for name, t in (("hx", hx), ("hy", hy), ("hz", hz)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"gs_phase: {name} must be a 1-D tensor.")
    nx, ny, nz = hx.numel(), hy.numel(), hz.numel()
    if min(nx, ny, nz) < 2 or px not in (0, 1) or py not in (0, 1) \
            or pz not in (0, 1):
        raise ValueError(
            f"gs_phase: need >= 2 cells per axis and parities in {{0, 1}}; "
            f"got cells {(nx, ny, nz)}, parity {(px, py, pz)}.")
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

    ncx, ncy, ncz = ((n - p) // 2 for n, p in ((nx, px), (ny, py),
                                                (nz, pz)))
    if ncx * ncy * ncz == 0:
        return ex, ey, ez          # Empty phase: no launch of 0 blocks.

    fn = _func(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(_ptr(t) for t in (ex, ey, ez, sx, sy, sz, eta_x, eta_y,
                                     eta_z, zeta, hx, hy, hz)),
                 nx, ny, nz, px, py, pz, stream)
    if err != 0:
        raise RuntimeError(
            f"gs_phase: kernel launch failed with cudaError {err} "
            f"(cells {(nx, ny, nz)}, parity {(px, py, pz)}, {ex.dtype}).")
    LAUNCHES += 1
    return ex, ey, ez
