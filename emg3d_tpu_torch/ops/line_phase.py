"""The ``line_phase`` CUDA kernel: one 4-color line-relaxation phase.

No TPU kernel is replaced: the JAX package runs the line phase
(``emg3d_tpu.ops.smoothers._line_relax_x_phase`` and ``_block_thomas``)
as XLA ``lax.scan`` loops.  Eager PyTorch would run its block-Thomas as
some 16,000 small launches per phase, so the port runs one phase as one
hand-written kernel, ``csrc/line_phase.cu``: a team of 8 lanes per line
(4 lines per warp) shares the assembly and the 5x5 algebra of the line's
block-Thomas solve, whose intermediate blocks go through a scratch
tensor in device memory.

The launch path is split in two, because a smoothing call launches
nu x 4 phases on the same tensors, and on the coarse levels the host,
not the kernel, bounds back-to-back launches:

- :class:`LinePlan` is built once from the 13 tensors, the axis and the
  optional per-task eta scale of the batch engine.  It runs every check
  (``_operands.check``), looks up the entry point, the pointers and the
  frame geometry (:func:`line_geometry`), and allocates the scratch
  once, sized for the parity with most lines, one such per task.
- :meth:`LinePlan.launch` does only the stream lookup, the ``ctypes``
  call, the error check and the count.  A plan lives for one smoothing call, in which the
  fields are updated in place; nothing is cached across calls.

:func:`gauss_seidel_line_phase_cuda` is plan and launch in one call.
Fields may carry a leading task axis: one launch relaxes one color of
every task (see ``_operands`` for the layouts).  Two plain-integer
counters:

- ``LAUNCHES``: kernel launches (one per :meth:`LinePlan.launch` whose
  phase has lines; a launch recorded into a CUDA graph counts once, when
  it is recorded, and the graph's replays, which do not call the
  wrapper, count nothing here);
- ``PLAIN_CALLS_ON_CUDA``: calls of the plain PyTorch version
  (``smoothers._line_relax_phase_torch``) with CUDA tensors, which only
  comparisons with the kernel make.

The y- and z-lines are the x-lines of a permuted frame
(``FRAMES``).  The kernel reads the untransposed
C-contiguous tensors through the strides of their permuted views, so no
transpose is copied.
"""

import ctypes
import math

import torch

from emg3d_tpu_torch.ops import _build, _operands

__all__ = ["gauss_seidel_line_phase_cuda", "LinePlan", "line_geometry",
           "LAUNCHES", "PLAIN_CALLS_ON_CUDA", "reset_counts", "FRAMES",
           "SCRATCH_VALUES"]

LAUNCHES = 0
PLAIN_CALLS_ON_CUDA = 0

# Values the kernel keeps per line and group for the backward pass: the
# 5x5 block W_g = C_g^{-1} L_{g+1}^T and the 5-vector z_g = C_g^{-1} y_g,
# as 5 rows of [W_g[i, :], z_g[i]].
SCRATCH_VALUES = 30

# The permuted frame of each line axis: frame axis i is original axis
# FRAMES[axis][i], and the original component FRAMES[axis][i] (of the
# fields, sources, eta and widths) plays the frame's i-th role.
FRAMES = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 1, 0)}

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
                       + [ctypes.c_int64] + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _FUNCS[entry] = fn
    return _FUNCS[entry]


def line_geometry(cells, strides, axis):
    """The frame of the lines along ``axis``, from plain integers.

    ``cells``: (nx, ny, nz); ``strides``: the element strides of ``ex``,
    ``ey``, ``ez`` and of a cell array (four 3-tuples), untransposed.
    Returns ``(frame_cells, frame_strides, lines)``:

    - ``frame_cells`` (NX, NY, NZ): lines along frame x, of NX cells;
      the transverse frame axes y and z carry the parities;
    - ``frame_strides``: 12 integers, the strides of the permuted views
      (``t.permute(FRAMES[axis])``) of the frame's edge arrays of the x,
      y and z role (original component ``FRAMES[axis][i]`` plays role
      i), then of the cell arrays;
    - ``lines``: {(p1, p2): lines of that parity}, 0 where a parity has
      none.
    """
    tp = FRAMES[axis]
    NX, NY, NZ = (cells[r] for r in tp)
    frame_strides = tuple(strides[a][d] for a in (*tp, 3) for d in tp)
    lines = {(p1, p2): ((NY - p1) // 2) * ((NZ - p2) // 2)
             for p1 in (0, 1) for p2 in (0, 1)}
    return (NX, NY, NZ), frame_strides, lines


class LinePlan:
    """Everything one smoothing call needs to launch its line phases.

    Built from the 13 tensors of a phase, the line axis and an optional
    per-task eta ``scale``; see :func:`gauss_seidel_line_phase_cuda` for
    what they must be.  Raises on anything the kernel does not take and
    on a failed build.
    """

    def __init__(self, ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                 hx, hy, hz, axis, scale=None):
        tensors = (ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                   hx, hy, hz)
        entry, cells, self._ntask, eta_tstride = _operands.check(
            "line_phase", *tensors, scale=scale)
        if axis not in FRAMES:
            raise ValueError(
                f"line_phase: axis must be 0, 1, or 2; got {axis}.")

        frame, strides, self._lines = line_geometry(
            cells, tuple(t.stride()[-3:] for t in (ex, ey, ez, zeta)), axis)
        tp = FRAMES[axis]
        # Task strides: a task's edge array of each frame role, its eta
        # (0 if shared) and its scratch.
        per_task = (max(frame[0] - 1, 1) * SCRATCH_VALUES
                    * max(self._lines.values()))
        tstrides = (*(math.prod(tensors[r].shape[-3:]) for r in tp),
                    eta_tstride, per_task)
        self._geo = (ctypes.c_int64 * 20)(*frame, *strides, *tstrides)
        self._scratch = torch.empty(self._ntask * per_task, dtype=ex.dtype,
                                    device=ex.device)
        e, s = (ex, ey, ez), (sx, sy, sz)
        eta, h = (eta_x, eta_y, eta_z), (hx, hy, hz)
        # The tensors (and the scale) are referenced for as long as their
        # pointers are.
        self._tensors = (*(e[r] for r in tp), *(s[r] for r in tp),
                         *(eta[r] for r in tp), zeta, *(h[r] for r in tp),
                         self._scratch)
        self._scale = scale
        self._args = (*(_operands.ptr(t) for t in self._tensors),
                      ctypes.addressof(self._geo))
        self._tail = (self._ntask,
                      None if scale is None else _operands.ptr(scale))
        self._fn = _func(entry)
        self._device = ex.device
        self._what = (f"cells {cells}, axis {axis}, {self._ntask} task(s), "
                      f"{ex.dtype}")

    def launch(self, p1, p2):
        """Relax the lines of transverse parity (p1, p2) of every task, in
        place, on the device's current stream."""
        global LAUNCHES
        nlines = self._lines.get((p1, p2))
        if nlines is None:
            raise ValueError(
                f"line_phase: parities must be in {{0, 1}}; got "
                f"{(p1, p2)}.")
        if nlines == 0:
            return                     # Empty phase: no launch of 0 blocks.
        stream = torch.cuda.current_stream(self._device).cuda_stream
        if torch.cuda.current_device() == self._device.index:
            err = self._fn(*self._args, p1, p2, *self._tail, stream)
        else:
            with torch.cuda.device(self._device):
                err = self._fn(*self._args, p1, p2, *self._tail, stream)
        if err != 0:
            raise RuntimeError(
                f"line_phase: kernel launch failed with cudaError {err} "
                f"({self._what}, parity {(p1, p2)}).")
        LAUNCHES += 1


def gauss_seidel_line_phase_cuda(ex, ey, ez, sx, sy, sz, eta_x, eta_y,
                                 eta_z, zeta, hx, hy, hz, p1, p2, axis,
                                 scale=None):
    """Relax the lines along ``axis`` of transverse parity (p1, p2).

    Same arguments and result as ``smoothers._line_relax_phase_torch``:
    updates ``ex``, ``ey``, ``ez`` IN PLACE and returns them.  Every
    tensor must lie on one CUDA device and be C-contiguous; fields,
    sources and eta share one dtype (complex64, complex128, float32 or
    float64), zeta and the widths are real of the same precision.
    Raises on anything else, on a failed build and on a failed launch.
    One plan (:class:`LinePlan`) and one launch.
    """
    LinePlan(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta, hx, hy, hz,
             axis, scale).launch(p1, p2)
    return ex, ey, ez
