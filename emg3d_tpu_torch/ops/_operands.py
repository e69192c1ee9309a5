"""The operand checks of the two CUDA kernels' wrappers.

``gs_phase.GsPlan`` and ``line_phase.LinePlan`` take the same 13 tensors
(fields, sources, eta, zeta, widths) and an optional per-task eta scale,
and their kernels read them by raw pointer: :func:`check` validates them
once per plan and raises on anything the kernels do not take.

Layouts (the batch engine, :mod:`emg3d_tpu_torch.parallel.batch`):

- fields and sources: ``(nx, ny+1, nz+1)`` etc., or with a leading task
  axis ``(B, ...)``;
- eta: shared ``(nx, ny, nz)``, or stacked ``(B, nx, ny, nz)`` with
  batched fields;
- ``scale``: None, or ``(B,)`` of the field dtype with batched fields and
  a shared eta (task k's eta is ``scale[k] * eta``);
- zeta ``(nx, ny, nz)`` and the widths are always shared.
"""

import math

import torch

__all__ = ["check", "ptr", "MAX_TASKS"]

# Entry-point suffix per field dtype, and the real dtype of zeta and the
# widths.
_DTYPES = {
    torch.complex64: ("c64", torch.float32),
    torch.complex128: ("c128", torch.float64),
    torch.float32: ("f32", torch.float32),
    torch.float64: ("f64", torch.float64),
}

# The task is the second grid dimension of both kernels.
MAX_TASKS = 65535


def ptr(t):
    """The data pointer of ``t`` (complex tensors read as (re, im))."""
    return (torch.view_as_real(t) if t.is_complex() else t).data_ptr()


def _check(kernel, name, t, device, dtype, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a torch.Tensor.")
    if t.device != device:
        raise ValueError(
            f"{kernel}: {name} is on {t.device}, expected {device}.")
    if t.dtype != dtype:
        raise TypeError(
            f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}.")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"{kernel}: {name} has shape {tuple(t.shape)}, expected "
            f"{shape}.")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be C-contiguous.")


def check(kernel, ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta, hx, hy,
          hz, scale=None):
    """Validate the operands of one phase of ``kernel``.

    Returns ``(entry, cells, ntask, eta_tstride)``: the name of the C
    entry point for the field dtype, (nx, ny, nz), the number of tasks
    (1 without a task axis) and the task stride of eta (0 if shared).
    """
    device = ex.device
    if device.type != "cuda":
        raise ValueError(
            f"{kernel}: tensors must be on a CUDA device, got {device}.")
    if ex.dtype not in _DTYPES:
        raise TypeError(
            f"{kernel}: unsupported field dtype {ex.dtype}; expected one "
            f"of {list(_DTYPES)}.")
    suffix, rdt = _DTYPES[ex.dtype]
    for name, t in (("hx", hx), ("hy", hy), ("hz", hz)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"{kernel}: {name} must be a 1-D tensor.")
    nx, ny, nz = cells = (hx.numel(), hy.numel(), hz.numel())
    if min(cells) < 2:
        raise ValueError(
            f"{kernel}: need >= 2 cells per axis; got cells {cells}.")
    if ex.dim() not in (3, 4):
        raise ValueError(
            f"{kernel}: fields must be 3-D, or 4-D with a leading task "
            f"axis; got shape {tuple(ex.shape)}.")
    lead = tuple(ex.shape[:-3])
    ntask = lead[0] if lead else 1
    if not 1 <= ntask <= MAX_TASKS:
        raise ValueError(
            f"{kernel}: need 1 to {MAX_TASKS} tasks; got {ntask}.")
    stacked = bool(lead) and isinstance(eta_x, torch.Tensor) \
        and eta_x.dim() == 4
    eta_shape = (*lead, *cells) if stacked else cells
    for name, t, shape, dt in (
            ("ex", ex, (*lead, nx, ny + 1, nz + 1), ex.dtype),
            ("ey", ey, (*lead, nx + 1, ny, nz + 1), ex.dtype),
            ("ez", ez, (*lead, nx + 1, ny + 1, nz), ex.dtype),
            ("sx", sx, (*lead, nx, ny + 1, nz + 1), ex.dtype),
            ("sy", sy, (*lead, nx + 1, ny, nz + 1), ex.dtype),
            ("sz", sz, (*lead, nx + 1, ny + 1, nz), ex.dtype),
            ("eta_x", eta_x, eta_shape, ex.dtype),
            ("eta_y", eta_y, eta_shape, ex.dtype),
            ("eta_z", eta_z, eta_shape, ex.dtype),
            ("zeta", zeta, cells, rdt),
            ("hx", hx, (nx,), rdt), ("hy", hy, (ny,), rdt),
            ("hz", hz, (nz,), rdt)):
        _check(kernel, name, t, device, dt, shape)
    if scale is not None:
        if not lead or stacked:
            raise ValueError(
                f"{kernel}: an eta scale needs fields with a task axis and "
                "a shared eta.")
        _check(kernel, "scale", scale, device, ex.dtype, lead)
    eta_tstride = math.prod(cells) if stacked else 0
    return f"{kernel}_{suffix}", cells, ntask, eta_tstride
