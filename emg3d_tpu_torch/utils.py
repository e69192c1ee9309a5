"""Utilities: timer, report, EMArray, serialization registry, soft-dep gating.

Copy of ``emg3d_tpu.utils`` for the PyTorch port (numpy only; the text
below speaks of the JAX package it was written for).
Counterpart of the reference's emg3d/utils.py (Timer
utils.py:169-198, EMArray via empymod, _known_class utils.py:57-63,
_requires utils.py:66-118).  EMArray is implemented natively here since
empymod is not a dependency of this framework.
"""

import importlib
from datetime import datetime, timedelta
from timeit import default_timer

import numpy as np

__version__ = "0.1.0"

__all__ = ["Report", "EMArray", "Timer"]

# Serialization registry: maps class-name -> class, used by io.py to
# reconstruct instances from dicts (reference: emg3d/utils.py:53-63).
_KNOWN_CLASSES = {}


def _known_class(func):
    """Register class as known for the I/O layer."""
    _KNOWN_CLASSES[func.__name__] = func
    return func


def _requires(*names, **kwargs):
    """Decorator gating a function on optional soft dependencies.

    If one of ``names`` is not importable, calling the function warns and
    returns None (reference: emg3d/utils.py:66-118).
    """

    def decorator(func):
        missing = []
        for name in names:
            if importlib.util.find_spec(name) is None:
                missing.append(name)

        if not missing:
            return func

        def wrapper(*args, **kw):
            import warnings

            warnings.warn(
                f"`{func.__name__}` requires {missing}; not installed.",
                UserWarning,
            )
            return None

        wrapper.__doc__ = func.__doc__
        return wrapper

    return decorator


class EMArray(np.ndarray):
    """ndarray subclass with amplitude and phase attributes.

    Native implementation of the EMArray that the reference imports from
    empymod (emg3d/utils.py:34-40).  ``amp()`` returns the amplitude,
    ``pha()`` the phase, with options for degrees, unwrapping, and lag/lead
    convention.
    """

    def __new__(cls, data):
        return np.asarray(data).view(cls)

    def amp(self):
        """Amplitude of the electromagnetic field."""
        return np.abs(self.view())

    def pha(self, deg=False, unwrap=True, lag=True):
        """Phase of the electromagnetic field.

        Parameters
        ----------
        deg : bool, default: False
            Degrees if True, radians if False.
        unwrap : bool, default: True
            Unwrap the phase.
        lag : bool, default: True
            Lag (+iwt) convention if True, lead (-iwt) if False.
        """
        if lag:
            pha = np.angle(self.view())
        else:
            pha = np.angle(np.conj(self.view()))
        if unwrap and self.size > 1:
            pha = np.unwrap(pha)
        if deg:
            pha *= 180 / np.pi
        return EMArray(pha)


class Timer:
    """Wall-clock timer that can be started and stopped.

    Mirrors emg3d/utils.py:169-198.
    """

    def __init__(self):
        self._t0 = default_timer()

    def __repr__(self):
        return f"Runtime : {self.runtime}"

    @property
    def t0(self):
        """Start time (timeit.default_timer)."""
        return self._t0

    @property
    def now(self):
        """Current time as hh:mm:ss string."""
        return datetime.now().strftime("%H:%M:%S")

    @property
    def runtime(self):
        """Elapsed time as hh:mm:ss string."""
        return str(timedelta(seconds=np.round(self.elapsed)))

    @property
    def elapsed(self):
        """Elapsed time in seconds."""
        return default_timer() - self._t0


class Report:
    """Environment report (versions of the relevant packages).

    Lightweight, dependency-free replacement of the scooby-based Report of
    the reference (emg3d/utils.py:122-166).
    """

    def __init__(self, add_pckg=None, **kwargs):
        import platform
        import sys

        self.packages = {}
        core = ["numpy", "scipy", "torch", "emg3d_tpu_torch", "h5py"]
        for name in core + list(add_pckg or []):
            try:
                mod = importlib.import_module(name)
                self.packages[name] = getattr(mod, "__version__", "unknown")
            except ImportError:
                self.packages[name] = None
        self.python = sys.version
        self.platform = platform.platform()
        try:
            import torch

            self.devices = [torch.cuda.get_device_name(i)
                            for i in range(torch.cuda.device_count())]
        except ImportError:
            self.devices = []

    def __repr__(self):
        lines = ["-" * 60]
        lines.append(f"  Date: {datetime.now().strftime('%c')}")
        lines.append(f"  Platform: {self.platform}")
        lines.append(f"  Python: {self.python.split()[0]}")
        lines.append(f"  Devices: {', '.join(self.devices) or 'none'}")
        for name, version in self.packages.items():
            lines.append(f"  {name}: {version or 'not installed'}")
        lines.append("-" * 60)
        return "\n".join(lines)
