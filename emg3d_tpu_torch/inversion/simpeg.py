"""SimPEG bridge (placeholder, as in the reference and in
``emg3d_tpu.inversion``).

The reference wrapper is itself a placeholder (emg3d/inversion/
simpeg.py:39-47); this module import-guards SimPEG and will host the
forward-operator adapter once the upstream interface stabilizes.
"""

try:
    import simpeg
except ImportError:
    simpeg = None

__all__ = []


def __dir__():
    return __all__


if simpeg is not None:
    print("NOTE: SimPEG(emg3d-tpu-torch) is in development.")
