"""Carry host state over from ``emg3d_tpu`` objects.

:func:`from_emg3d_tpu` rebuilds an object of the JAX package (a
``TensorMesh``, ``Model``, ``Field``, ``Survey``, ``Simulation`` or any
source or receiver) as the port's class of the same name, through the
object's ``to_dict()`` and the port class's ``from_dict``.  Both packages
then compute on identical numpy state.  This module never imports
``emg3d_tpu``: it only reads the dict.
"""

from emg3d_tpu_torch import (electrodes, fields, io, meshes, models,
                             simulations, surveys)

__all__ = ["from_emg3d_tpu"]

_CLASSES = {
    "TensorMesh": meshes.TensorMesh,
    "Model": models.Model,
    "Field": fields.Field,
    "Survey": surveys.Survey,
    "Simulation": simulations.Simulation,
    **{name: getattr(electrodes, name) for name in electrodes.__all__
       if name.startswith(("Tx", "Rx"))},
}


def from_emg3d_tpu(obj, **kwargs):
    """The port's object equal to ``obj``.

    ``kwargs`` are added to the dict before the port's ``from_dict`` reads
    it: a ``Simulation`` of the JAX package knows no ``device``, so
    ``from_emg3d_tpu(simulation, device='cpu')`` says where the port's
    runs (with none given it runs on the card).  Objects nested in the
    dict (the cached fields and grids of a simulation) are carried over
    too.
    """
    name = type(obj).__name__
    if name not in _CLASSES:
        raise TypeError(
            f"from_emg3d_tpu converts {sorted(_CLASSES)}; got {name!r}.")
    plain = io._dict_serialize_one({**obj.to_dict(copy=True), **kwargs})
    return _CLASSES[name].from_dict(plain)
