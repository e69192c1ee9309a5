"""Survey fan-out of the PyTorch port.

Port of ``emg3d_tpu.parallel``: the sequential task engine
(:mod:`emg3d_tpu_torch.parallel.tasks`).  The batched engine
(``emg3d_tpu.parallel.batch``) and the grid sharding
(``emg3d_tpu.parallel.domain``) are not ported yet.
"""

from emg3d_tpu_torch.parallel.tasks import process_map, solve, layered

__all__ = ['process_map', 'solve', 'layered']
