"""The ``gs_phase`` CUDA kernel: one 8-color point Gauss-Seidel phase.

Counterpart of ``emg3d_tpu.ops.pallas_gs``: the hand-written Hopper
kernel ``csrc/gs_phase.cu`` replaces both Pallas kernels there (the
whole-phase and the tiled form compute the same function).

A smoothing call launches nu x 8 phases on the same tensors, so the
launch path is split in two, as for ``line_phase``:

- :class:`GsPlan` is built once from the 13 tensors (and the optional
  per-task eta scale of the batch engine).  It runs every check
  (``_operands.check``), looks up the entry point and the pointers.
- :meth:`GsPlan.launch` does only the stream lookup, the ``ctypes`` call,
  the error check and the count.

:func:`gauss_seidel_phase_cuda` is plan and launch in one call.  Fields
may carry a leading task axis: one launch relaxes one color of every task
(see ``_operands`` for the layouts).  Two plain-integer counters:

- ``LAUNCHES``: kernel launches (one per :meth:`GsPlan.launch` whose
  phase has nodes);
- ``PLAIN_CALLS_ON_CUDA``: calls of the plain PyTorch version
  (``smoothers._gauss_seidel_phase_torch``) with CUDA tensors, which only
  comparisons with the kernel make.

The plain version is ``emg3d_tpu_torch.ops.smoothers._gauss_seidel_phase_torch``.
"""

import ctypes

import torch

from emg3d_tpu_torch.ops import _build, _operands

__all__ = ["gauss_seidel_phase_cuda", "GsPlan", "LAUNCHES",
           "PLAIN_CALLS_ON_CUDA", "reset_counts"]

LAUNCHES = 0
PLAIN_CALLS_ON_CUDA = 0

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
                       + [ctypes.c_int] * 3 + [ctypes.c_int64] * 2
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _FUNCS[entry] = fn
    return _FUNCS[entry]


class GsPlan:
    """Everything one smoothing call needs to launch its point phases.

    Built from the 13 tensors of a phase and an optional per-task eta
    ``scale``; see :func:`gauss_seidel_phase_cuda` for what they must be.
    Raises on anything the kernel does not take and on a failed build.
    """

    def __init__(self, ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                 hx, hy, hz, scale=None):
        tensors = (ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                   hx, hy, hz)
        entry, self._cells, ntask, eta_tstride = _operands.check(
            "gs_phase", *tensors, scale=scale)
        # The tensors are referenced for as long as their pointers are.
        self._tensors = (*tensors, scale)
        self._ptrs = tuple(_operands.ptr(t) for t in tensors)
        self._tail = (ntask, eta_tstride,
                      None if scale is None else _operands.ptr(scale))
        self._fn = _func(entry)
        self._device = ex.device
        self._what = f"cells {self._cells}, {ntask} task(s), {ex.dtype}"

    def launch(self, px, py, pz):
        """Relax the interior nodes of parity (px, py, pz) of every task,
        in place, on the device's current stream."""
        global LAUNCHES
        if px not in (0, 1) or py not in (0, 1) or pz not in (0, 1):
            raise ValueError(
                f"gs_phase: parities must be in {{0, 1}}; got "
                f"{(px, py, pz)}.")
        nx, ny, nz = self._cells
        if (nx - px) // 2 * ((ny - py) // 2) * ((nz - pz) // 2) == 0:
            return                     # Empty phase: no launch of 0 blocks.
        stream = torch.cuda.current_stream(self._device).cuda_stream
        args = (*self._ptrs, nx, ny, nz, px, py, pz, *self._tail, stream)
        if torch.cuda.current_device() == self._device.index:
            err = self._fn(*args)
        else:
            with torch.cuda.device(self._device):
                err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"gs_phase: kernel launch failed with cudaError {err} "
                f"({self._what}, parity {(px, py, pz)}).")
        LAUNCHES += 1


def gauss_seidel_phase_cuda(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                            zeta, hx, hy, hz, px, py, pz, scale=None):
    """Relax the interior nodes of parity (px, py, pz) with the kernel.

    Same arguments and result as
    ``smoothers._gauss_seidel_phase_torch``: updates ``ex``, ``ey``,
    ``ez`` IN PLACE and returns them.  Every tensor must lie on one CUDA
    device and be C-contiguous; fields, sources and eta share one dtype
    (complex64, complex128, float32 or float64), zeta and the widths
    are real of the same precision.  Raises on anything else, on a
    failed build and on a failed launch.  One plan (:class:`GsPlan`) and
    one launch.
    """
    GsPlan(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta, hx, hy, hz,
           scale).launch(px, py, pz)
    return ex, ey, ez
