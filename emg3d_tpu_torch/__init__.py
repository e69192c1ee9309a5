"""emg3d_tpu_torch: the PyTorch/CUDA port of emg3d_tpu.

Multigrid solver for 3-D electromagnetic diffusion (CSEM) on one NVIDIA
GPU.  Plain tensor code is PyTorch; the smoothing phases, where the
solver spends its time, are hand-written CUDA kernels: the point
Gauss-Seidel phase (``ops/gs_phase.py``, ``csrc/gs_phase.cu``) and the
line-relaxation phase (``ops/line_phase.py``, ``csrc/line_phase.cu``).
Entry points run on the card unless the caller passes ``device='cpu'``;
on the CPU every operation runs its plain PyTorch version, which the
tests hold against emg3d_tpu.

This package imports neither ``jax`` nor ``emg3d_tpu``.  The public API
mirrors emg3d_tpu (reference emg3d/__init__.py:18-33) for the ported
slices: ``solve`` with the default MG-preconditioned BiCGSTAB,
semicoarsening and line relaxation, or stand-alone multigrid
(``plain=True``); ``solve_batch``/``solve_batch_fields``, many
(source, frequency) tasks as one batched solve; ``Survey`` and
``Simulation`` (forward fields, misfit, adjoint-state gradient,
``jvec``/``jtvec``) over the sequential task engine or the batched one
(``parallel='batch'``); magnetic fields; ``save``/``load``; the
``Fourier`` time-domain transform.
"""

# ``convert`` is, as in emg3d_tpu, the function of ``io``; the module
# ``emg3d_tpu_torch.convert`` is imported first, so that no later import of
# it rebinds the name (``from emg3d_tpu_torch.convert import ...`` works).
from emg3d_tpu_torch.convert import from_emg3d_tpu
from emg3d_tpu_torch.electrodes import (
    TxElectricPoint, TxMagneticPoint, TxElectricDipole, TxMagneticDipole,
    TxElectricWire, RxElectricPoint, RxMagneticPoint)
from emg3d_tpu_torch.fields import (
    Field, get_receiver, get_source_field, get_magnetic_field)
from emg3d_tpu_torch.io import save, load, convert
from emg3d_tpu_torch.meshes import TensorMesh, construct_mesh
from emg3d_tpu_torch.models import Model
from emg3d_tpu_torch.parallel.batch import solve_batch, solve_batch_fields
from emg3d_tpu_torch.simulations import Simulation
from emg3d_tpu_torch.solver import solve, solve_source
from emg3d_tpu_torch.surveys import Survey
from emg3d_tpu_torch.time import Fourier
from emg3d_tpu_torch.utils import Report, __version__

__all__ = [
    'TxElectricPoint', 'TxMagneticPoint', 'TxElectricDipole',
    'TxMagneticDipole', 'TxElectricWire', 'RxElectricPoint',
    'RxMagneticPoint', 'Field', 'get_source_field', 'get_receiver',
    'get_magnetic_field', 'save', 'load', 'convert', 'TensorMesh',
    'construct_mesh', 'Model', 'Simulation', 'solve', 'solve_source',
    'solve_batch', 'solve_batch_fields',
    'Survey', 'Fourier', 'Report', 'from_emg3d_tpu', '__version__',
]
