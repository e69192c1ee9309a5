"""Command-line interface of the PyTorch port (``emg3d-torch``,
``python -m emg3d_tpu_torch``).

Copy of ``emg3d_tpu.cli`` (reference emg3d/cli/): an argparse front end
over an INI-style config file (``emg3d.cfg``) driving forward, misfit and
gradient batch runs of a Simulation, with load/save/cache resume.  The
config's ``[simulation]`` section takes one key more, ``device``: no key
means the CUDA card, as every entry point of the port.
"""

from emg3d_tpu_torch.cli.main import main

__all__ = ['main']
