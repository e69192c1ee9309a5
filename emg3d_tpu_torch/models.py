"""Electromagnetic material properties (models) for the solver.

Copy of ``emg3d_tpu.models`` for the PyTorch port (numpy only; the text
below speaks of the JAX package it was written for).
Rebuild of the reference's emg3d/models.py.  The ``Model`` is a
host-side container (setup/IO); the solver-facing ``VolumeModel`` computes
the frequency-scaled parameters

    eta_{x,y,z} = -V i omega mu_0 (sigma_{x,y,z} + i omega eps)   (cells)
    zeta        = V / mu_r                                        (cells)

(reference models.py:633-691) which enter the jitted compute path as device
arrays.
"""

from copy import deepcopy

import numpy as np
import scipy as sp

from emg3d_tpu_torch import maps, meshes, tracing, utils

__all__ = ["Model", "VolumeModel", "expand_grid_model"]


def __dir__():
    return __all__


# (has property_y, has property_z) -> anisotropy case.
_ANISOTROPY_CASES = {
    (False, False): "isotropic",
    (True, False): "HTI",
    (False, True): "VTI",
    (True, True): "triaxial",
}


class _MaterialProperty:
    """Data descriptor for one optional (nx, ny, nz) model parameter.

    Reads return the stored array (or None).  Writes update the stored
    array in place after validation; writing to a parameter the model
    was created without is an error (reference models.py:173-316 keeps
    the five parameters behind individual property/setter pairs).
    """

    def __init__(self, doc):
        self.__doc__ = doc

    def __set_name__(self, owner, name):
        self.public = name
        self.slot = "_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self.slot)

    def __set__(self, obj, values):
        if getattr(obj, self.slot) is None:
            raise ValueError(
                f"Model was initiated without `{self.public}`; "
                "cannot set values.")
        obj._validate(values, self.public)
        getattr(obj, self.slot)[...] = np.asarray(values, dtype=np.float64)


@utils._known_class
class Model:
    """A model of cell-centered electromagnetic properties of the earth.

    Supports the four anisotropy cases of the reference
    (emg3d/models.py:134-141): isotropic, HTI, VTI, triaxial; plus optional
    ``mu_r`` and ``epsilon_r``.  Properties are stored as (nx, ny, nz)
    float64 arrays; the ``mapping`` decides what they physically mean.
    """

    property_x = _MaterialProperty("Electrical property in x-direction.")
    property_y = _MaterialProperty("Electrical property in y-direction.")
    property_z = _MaterialProperty("Electrical property in z-direction.")
    mu_r = _MaterialProperty("Relative magnetic permeability.")
    epsilon_r = _MaterialProperty("Relative electric permittivity.")

    _properties = ["property_x", "property_y", "property_z",
                   "mu_r", "epsilon_r"]

    def __init__(self, grid, property_x=1.0, property_y=None, property_z=None,
                 mu_r=None, epsilon_r=None, mapping="Resistivity"):
        self.grid = grid
        self.shape = tuple(grid.shape_cells)
        self.size = int(grid.n_cells)

        self.map = (mapping if isinstance(mapping, maps.BaseMap)
                    else getattr(maps, "Map" + mapping)())

        given = {"property_x": property_x, "property_y": property_y,
                 "property_z": property_z, "mu_r": mu_r,
                 "epsilon_r": epsilon_r}
        for name, values in given.items():
            setattr(self, "_" + name, self._ingest(values, name))

        self.case = _ANISOTROPY_CASES[
            self._property_y is not None, self._property_z is not None]

    def __repr__(self):
        extras = "".join(
            f"; {name}" for name in ("mu_r", "epsilon_r")
            if getattr(self, name) is not None)
        nx, ny, nz = self.shape
        return (f"{type(self).__name__}: {self.map.description}; "
                f"{self.case}{extras}; {nx} x {ny} x {nz} "
                f"({self.size:,})")

    # Operators -------------------------------------------------------------

    def _combine(self, other, ufunc):
        if type(other).__name__ != "Model":
            return NotImplemented
        self._compatible(other)
        merged = {prop: ufunc(getattr(self, prop), getattr(other, prop))
                  for prop in self._def_properties}
        return Model(grid=self.grid, mapping=self.map.name, **merged)

    def __add__(self, model):
        return self._combine(model, np.add)

    def __sub__(self, model):
        return self._combine(model, np.subtract)

    def __eq__(self, model):
        if type(model).__name__ != "Model":
            return False
        try:
            self._compatible(model)
        except ValueError:
            return False
        return all(np.allclose(getattr(self, prop), getattr(model, prop))
                   for prop in self._def_properties)

    # Serialization ----------------------------------------------------------

    def copy(self):
        """Return a copy of the Model."""
        return self.from_dict(self.to_dict(True))

    def to_dict(self, copy=False):
        """Store the necessary information in a dict."""
        out = {
            "__class__": type(self).__name__,
            "grid": meshes.TensorMesh(
                self.grid.h, self.grid.origin).to_dict(),
            **{prop: getattr(self, prop) for prop in self._properties},
            "mapping": self.map.name,
        }
        return deepcopy(out) if copy else out

    @classmethod
    def from_dict(cls, inp):
        """Re-create a Model from a dict as given by ``to_dict``."""
        inp = {k: v for k, v in inp.items() if k != "__class__"}
        grid = inp.pop("grid")
        if isinstance(grid, dict):  # io may have deserialized it already.
            MeshClass = getattr(
                meshes, grid.get("__class__", "TensorMesh"))
            grid = MeshClass.from_dict(grid)
        return cls(grid=grid, **inp)

    @property
    def _def_properties(self):
        """List of the defined (not-None) properties."""
        return [k for k in self._properties
                if getattr(self, k) is not None]

    # Interpolation / extraction ---------------------------------------------

    def interpolate_to_grid(self, grid, **interpolate_opts):
        """Interpolate the model to a new grid (volume-average, log scale).

        Reference: emg3d/models.py:322-366.
        """
        if grid == self.grid:
            return self

        opts = {
            "method": "volume",
            "extrapolate": True,
            "log": not self.map.name.startswith("L"),
            **(interpolate_opts or {}),
            "grid": self.grid,
            "xi": grid,
        }
        moved = {prop: maps.interpolate(values=getattr(self, prop), **opts)
                 for prop in self._def_properties}
        return Model(grid, mapping=self.map.name, **moved)

    def extract_1d(self, method, p0, p1=None, ellipse=None, merge=False,
                   return_imat=False):
        """Return a layered (1D) model along (p0, p1).

        Methods 'midpoint', 'cylinder', 'prism'
        (reference: emg3d/models.py:368-544).
        """
        ellipse = {} if ellipse is None else ellipse

        methods = ["midpoint", "cylinder", "prism"]
        if method not in methods:
            raise ValueError(
                f"Unknown method '{method}'; implemented: {methods}.")
        if method != "midpoint" and "radius" not in ellipse:
            raise TypeError(
                f"Method '{method}' requires the dict 'ellipse' "
                "containing at least the parameter 'radius'.")

        midpoint = method == "midpoint"
        if p1 is None:
            p1 = p0

        if not midpoint:
            coo = (self.grid.cell_centers_x, self.grid.cell_centers_y)
            use = maps.ellipse_indices(coo=coo, p0=p0, p1=p1, **ellipse)
            ix, iy = use.nonzero()
            if not ix.size:
                midpoint = True
            else:
                six, eix = ix.min(), ix.max()
                siy, eiy = iy.min(), iy.max()

        if midpoint:
            def index(nodes, coo):
                x = np.asarray(coo < np.r_[nodes, np.inf]).nonzero()[0][0] - 1
                return np.clip(x, 0, nodes.size - 2)

            six = eix = index(self.grid.nodes_x, (p0[0] + p1[0]) / 2)
            siy = eiy = index(self.grid.nodes_y, (p0[1] + p1[1]) / 2)

        imat = np.zeros(self.shape[:2])
        if not midpoint:
            pp = np.outer(self.grid.h[0][six:eix + 1],
                          self.grid.h[1][siy:eiy + 1])
            if method == "cylinder":
                pp = pp * use[six:eix + 1, siy:eiy + 1]
            pp = pp / pp.sum()
        else:
            pp = 1.0
        imat[six:eix + 1, siy:eiy + 1] = pp

        props = {}
        for prop in self._def_properties:
            values = getattr(self, prop)
            if not midpoint:
                if not self.map.name.startswith("L"):
                    values = np.log10(values)
                val = np.einsum("ij,ijk->k", imat, values)
                if not self.map.name.startswith("L"):
                    val = 10 ** val
            else:
                val = values[six, siy, :]
            props[prop] = val

        if merge:
            diff = np.zeros(self.shape[2])
            for v in props.values():
                diff += abs(np.diff(np.r_[-1, v]))
            ind = diff.nonzero()[0]
            props = {k: v[ind] for k, v in props.items()}
            hz = np.diff(np.r_[self.grid.nodes_z[ind],
                               self.grid.nodes_z[-1]])
        else:
            hz = self.grid.h[2]

        grid_out = meshes.TensorMesh(
            h=([self.grid.nodes_x[eix + 1] - self.grid.nodes_x[six]],
               [self.grid.nodes_y[eiy + 1] - self.grid.nodes_y[siy]],
               hz),
            origin=(self.grid.nodes_x[six], self.grid.nodes_y[siy],
                    self.grid.origin[2]))

        layered = Model(grid=grid_out, **props, mapping=self.map)

        if return_imat:
            return layered, imat
        return layered

    # Internal utilities -----------------------------------------------------

    def _ingest(self, values, name):
        """Cast, broadcast, and validate a property at construction."""
        if values is None:
            return None
        values = np.asarray(values, dtype=np.float64)
        if values.size == self.size:
            # Fortran-order reshape of flat input, for parity with the
            # reference's Fortran-raveled 1-D representation
            # (emg3d/models.py:557-559).
            values = values.reshape(self.shape, order="F").copy()
        elif values.shape == self.shape:
            values = values.copy()
        else:
            values = np.ones(self.shape) * values
        self._validate(values, name)
        return values

    def _validate(self, values, name):
        """Check values are positive (as conductivities) and finite."""
        mapped = np.asarray(values)
        if name.startswith("property_"):
            mapped = self.map.backward(mapped)
        if not np.all(np.real(mapped) > 0.0):
            raise ValueError(f"`{name}` must be all bigger than zero.")
        if not np.all(np.isfinite(mapped)):
            raise ValueError(f"`{name}` must be all finite.")

    def _compatible(self, model):
        """Consistency checks before add/sub/eq."""
        mismatches = {
            "Models have different grids.": self.grid != model.grid,
            "Models have different anisotropy.": self.case != model.case,
            "One model has mu_r, the other not.":
                (self.mu_r is None) != (model.mu_r is None),
            "One model has epsilon_r, the other not.":
                (self.epsilon_r is None) != (model.epsilon_r is None),
            "Models have different mappings.":
                self.map.name != model.map.name,
        }
        for message, bad in mismatches.items():
            if bad:
                raise ValueError(message)


class VolumeModel:
    """Solver-facing, frequency-scaled model: eta_{x,y,z} and zeta.

    eta = -smu0 * V * (sigma + sval * eps0 * epsilon_r), zeta = V / mu_r
    (reference: emg3d/models.py:627-717).  eta_y/eta_z alias eta_x unless
    HTI/VTI/triaxial.  Built in an ``emg3d.model.volume`` span.
    """

    def __init__(self, model, sfield):
        with tracing.span('emg3d.model.volume'):
            self.case = model.case
            self.grid = meshes.TensorMesh(model.grid.h, model.grid.origin)

            vol = self.grid.cell_volumes_3d
            displacement = (0.0 if model.epsilon_r is None else
                            sfield.sval * sp.constants.epsilon_0
                            * model.epsilon_r)

            def eta_of(prop):
                if prop is None:
                    return None
                sigma = model.map.backward(prop)
                return -sfield.smu0 * vol * (sigma + displacement)

            self._eta_x = eta_of(model.property_x)
            self._eta_y = eta_of(model.property_y)
            self._eta_z = eta_of(model.property_z)
            self._zeta = vol if model.mu_r is None else vol / model.mu_r

    @property
    def eta_x(self):
        """Volume-scaled eta in x-direction."""
        return self._eta_x

    @property
    def eta_y(self):
        """Volume-scaled eta in y-direction."""
        if self.case in ("HTI", "triaxial"):
            return self._eta_y
        return self._eta_x

    @property
    def eta_z(self):
        """Volume-scaled eta in z-direction."""
        if self.case in ("VTI", "triaxial"):
            return self._eta_z
        return self._eta_x

    @property
    def zeta(self):
        """Volume-scaled, isotropic zeta."""
        return self._zeta


def expand_grid_model(model, expand, interface):
    """Expand model and grid up to ``interface`` plus 100 m of air above.

    Deprecated in the reference but kept for parity
    (emg3d/models.py:720-801).
    """
    grid = model.grid

    def extend_property(prop, add_values, nadd):
        if getattr(model, prop) is None:
            return None
        # model.shape, not grid.shape_cells: `grid` is rebound to the
        # extended grid before this runs.
        prop_ext = np.zeros((model.shape[0], model.shape[1],
                             model.shape[2] + nadd))
        prop_ext[:, :, :-nadd] = getattr(model, prop)
        if nadd == 2:
            prop_ext[:, :, -2] = add_values[0]
        prop_ext[:, :, -1] = add_values[1]
        return prop_ext

    nzadd = 0
    hz_ext = grid.h[2]

    if grid.nodes_z[-1] < interface - 0.05:
        hz_ext = np.r_[hz_ext, interface - grid.nodes_z[-1]]
        nzadd += 1
    if grid.nodes_z[-1] <= interface + 0.001:
        hz_ext = np.r_[hz_ext, 100]
        nzadd += 1

    if nzadd > 0:
        grid = meshes.TensorMesh(
            [grid.h[0], grid.h[1], hz_ext], origin=grid.origin)
        model = Model(
            grid,
            extend_property("property_x", expand, nzadd),
            extend_property("property_y", expand, nzadd),
            extend_property("property_z", expand, nzadd),
            extend_property("mu_r", [1, 1], nzadd),
            extend_property("epsilon_r", [1, 1], nzadd),
            mapping=model.map.name)

    return model
