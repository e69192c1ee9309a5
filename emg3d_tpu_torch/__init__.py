"""emg3d_tpu_torch: the PyTorch/CUDA port of emg3d_tpu.

Multigrid solver for 3-D electromagnetic diffusion (CSEM) on one NVIDIA
GPU.  Plain tensor code is PyTorch; the point Gauss-Seidel phase, where
the solver spends its time, is a hand-written CUDA kernel
(``ops/gs_phase.py``, ``csrc/gs_phase.cu``).  On the CPU every operation
runs its plain PyTorch version, which the tests hold against emg3d_tpu.

This package imports neither ``jax`` nor ``emg3d_tpu``.  The public API
mirrors emg3d_tpu (reference emg3d/__init__.py:18-33) for the ported
slice: stand-alone multigrid (``solve(..., plain=True)``).
"""

from emg3d_tpu_torch.fields import Field, get_receiver, get_source_field
from emg3d_tpu_torch.meshes import TensorMesh
from emg3d_tpu_torch.models import Model
from emg3d_tpu_torch.solver import solve, solve_source
from emg3d_tpu_torch.utils import Report, __version__

__all__ = [
    'TensorMesh', 'Model', 'Field', 'get_source_field', 'get_receiver',
    'solve', 'solve_source', 'Report', '__version__',
]
