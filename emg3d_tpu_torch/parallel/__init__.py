"""Survey fan-out of the PyTorch port.

Port of ``emg3d_tpu.parallel``: the sequential task engine
(:mod:`emg3d_tpu_torch.parallel.tasks`) and the batched engine
(:mod:`emg3d_tpu_torch.parallel.batch`: tasks as a leading axis of one
solve on one device).  The grid sharding (``emg3d_tpu.parallel.domain``)
is not ported.
"""

from emg3d_tpu_torch.parallel.batch import solve_batch, solve_batch_fields
from emg3d_tpu_torch.parallel.tasks import process_map, solve, layered

__all__ = ['process_map', 'solve', 'layered', 'solve_batch',
           'solve_batch_fields']
