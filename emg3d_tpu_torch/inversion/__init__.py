"""Inversion bridges to third-party frameworks (lazy imports).

Port of ``emg3d_tpu.inversion``, a mirror of the reference's inversion
subpackage (emg3d/inversion/__init__.py:50-52): submodules are imported
on first attribute access so the wrappers' heavy dependencies stay
optional.
"""

import importlib as _importlib

submodules = [
    'native',
    'pygimli',
    'simpeg',
]

__all__ = submodules


def __dir__():
    return __all__


def __getattr__(name):
    if name in submodules:
        return _importlib.import_module(
            f"emg3d_tpu_torch.inversion.{name}")
    raise AttributeError(f"module 'emg3d_tpu_torch.inversion' has no "
                         f"attribute '{name}'")
