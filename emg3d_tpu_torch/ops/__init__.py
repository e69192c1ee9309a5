"""Compute kernels of the PyTorch port.

- :mod:`emg3d_tpu_torch.ops.operator`  — matrix-free operator A x and the
  residual (reference ``amat_x``, core.py:57-206), plain PyTorch.
- :mod:`emg3d_tpu_torch.ops.transfer`  — separable restriction with
  operator-dependent weights and bilinear prolongation, plain PyTorch.
- :mod:`emg3d_tpu_torch.ops.smoothers` — 8-color point Gauss-Seidel; its
  phase dispatches by device to the plain PyTorch version (CPU) or the
  hand-written CUDA kernel :mod:`emg3d_tpu_torch.ops.gs_phase`.
"""

from emg3d_tpu_torch.ops import gs_phase, operator, smoothers, transfer  # noqa: F401
