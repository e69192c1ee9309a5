"""Carry host state over from ``emg3d_tpu`` objects.

:func:`from_emg3d_tpu` rebuilds a ``TensorMesh``, ``Model`` or ``Field`` of
the JAX package as the port's class of the same name, through the
object's ``to_dict()`` and the port class's ``from_dict``.  Both packages
then compute on identical numpy state.  This module never imports
``emg3d_tpu``: it only reads the dict.
"""

from emg3d_tpu_torch import fields, meshes, models

__all__ = ["from_emg3d_tpu"]

_CLASSES = {
    "TensorMesh": meshes.TensorMesh,
    "Model": models.Model,
    "Field": fields.Field,
}


def from_emg3d_tpu(obj):
    """The port's ``TensorMesh``, ``Model`` or ``Field`` equal to ``obj``."""
    name = type(obj).__name__
    if name not in _CLASSES:
        raise TypeError(
            f"from_emg3d_tpu converts {sorted(_CLASSES)}; got {name!r}.")
    return _CLASSES[name].from_dict(obj.to_dict(copy=True))
