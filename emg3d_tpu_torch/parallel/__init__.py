"""Survey fan-out and multi-device layer of the PyTorch port.

Port of ``emg3d_tpu.parallel``: the sequential task engine
(:mod:`emg3d_tpu_torch.parallel.tasks`), the batched engine
(:mod:`emg3d_tpu_torch.parallel.batch`: tasks as a leading axis of one
solve, split over a 1-D device mesh with ``mesh=``) and the grid sharding
(:mod:`emg3d_tpu_torch.parallel.domain`: one solve's grid over a 2-D
device mesh, ``solve(..., mesh=)``).  A mesh is a list of
``torch.device`` entries driven by one host loop; an entry may repeat a
device.  :mod:`emg3d_tpu_torch.parallel.dryrun` drives both strategies.
"""

from emg3d_tpu_torch.parallel.batch import (
    solve_batch, solve_batch_fields, make_task_mesh)
from emg3d_tpu_torch.parallel.domain import (
    DeviceGrid, GridPlacement, make_grid_mesh)
from emg3d_tpu_torch.parallel.dryrun import dryrun_multichip
from emg3d_tpu_torch.parallel.tasks import process_map, solve, layered

__all__ = ['process_map', 'solve', 'layered', 'solve_batch',
           'solve_batch_fields', 'make_task_mesh', 'make_grid_mesh',
           'GridPlacement', 'DeviceGrid', 'dryrun_multichip']
