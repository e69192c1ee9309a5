"""pyGIMLi bridge (placeholder, as in the reference and in
``emg3d_tpu.inversion``).

The reference wrapper is itself a placeholder (emg3d/inversion/
pygimli.py); this module import-guards pyGIMLi and will host the
Jacobian adapter once the upstream interface stabilizes.
"""

try:
    import pygimli
except ImportError:
    pygimli = None

__all__ = []


def __dir__():
    return __all__


if pygimli is not None:
    print("NOTE: pyGIMLi(emg3d-tpu-torch) is in development.")
