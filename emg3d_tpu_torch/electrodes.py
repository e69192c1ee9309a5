"""Electrodes: sources, receivers, and their geometry.

Copy of ``emg3d_tpu.electrodes`` for the PyTorch port (numpy only; the text
below speaks of the JAX package it was written for).
Rebuild of the reference's emg3d/electrodes.py:42-872.  All of
this is host-side setup geometry (numpy); the resulting source vectors are
what enters the jitted compute path.

Class hierarchy (mirroring the reference):

    Wire ── Point ──┬─ TxElectricPoint / TxMagneticPoint (+ Source)
            │       └─ RxElectricPoint / RxMagneticPoint (+ Receiver)
            Dipole ─── TxElectricDipole / TxMagneticDipole (+ Source)
            Wire ───── TxElectricWire (+ Source)
"""

from copy import deepcopy
from functools import cached_property

import numpy as np
import scipy as sp

from emg3d_tpu_torch import utils

__all__ = [
    "TxElectricPoint", "TxMagneticPoint", "TxElectricDipole",
    "TxMagneticDipole", "TxElectricWire", "RxElectricPoint",
    "RxMagneticPoint", "rotation", "point_to_dipole", "dipole_to_point",
    "point_to_square_loop",
]


def __dir__():
    return __all__


def _fmt_center(p):
    return f"center={{{p[0]:,.1f}; {p[1]:,.1f}; {p[2]:,.1f}}} m; "


def _fmt_repr(head, first, rest):
    """Class header plus a body that wraps onto a third line if long."""
    if len(first) + len(rest) < 80:
        return f"{head}\n    {first}{rest}"
    return f"{head}\n    {first}\n    {rest}"


class Wire:
    """An arbitrary number of electrodes connected in series.

    Reference: emg3d/electrodes.py:42-205.
    """

    _serialize = {"coordinates"}

    def __init__(self, coordinates):
        pts = np.atleast_2d(np.asarray(coordinates, dtype=float))
        if pts.ndim != 2 or pts.shape[-1] != 3:
            raise ValueError(
                "`coordinates` must be of shape (x, 3), provided: "
                f"{coordinates}")
        self._points = pts

    # ------------------------------------------------------------------
    # Identity and (de-)serialization.
    # ------------------------------------------------------------------

    def __eq__(self, other):
        if type(self).__name__ != type(other).__name__:
            return False
        for key in self._serialize:
            mine = getattr(self, key)
            theirs = getattr(other, key)
            same = (np.allclose(mine, theirs)
                    if isinstance(mine, np.ndarray) else mine == theirs)
            if not same:
                return False
        return True

    def to_dict(self, copy=False):
        """Store the necessary information in a dict."""
        out = {"__class__": type(self).__name__}
        out.update((key, getattr(self, key)) for key in self._serialize)
        return deepcopy(out) if copy else out

    @classmethod
    def from_dict(cls, inp):
        """Re-create the electrode from a dict as given by ``to_dict``."""
        inp = {k: v for k, v in inp.items() if k != "__class__"}
        return cls(**inp)

    def copy(self):
        """Return a copy of the electrode."""
        return self.from_dict(self.to_dict(True))

    def __repr__(self):
        head = f"{type(self).__name__}: {getattr(self, '_repr_add', '')}"
        return _fmt_repr(
            head, _fmt_center(self.center),
            f"n={self.segment_n}; l={self.length:,.1f} m")

    # ------------------------------------------------------------------
    # Geometry.
    # ------------------------------------------------------------------

    @property
    def points(self):
        """Electrode locations (n, 3)."""
        return self._points

    @property
    def coordinates(self):
        """Electrode coordinates as accepted by its class."""
        return getattr(self, "_coordinates", self._points)

    @cached_property
    def xtype(self):
        """'electric' or 'magnetic' (idealized-dipole flag)."""
        return ("magnetic" if "Magnetic" in type(self).__name__
                else "electric")

    @cached_property
    def center(self):
        """Center point of all unique electrodes."""
        return np.unique(self.points, axis=0).mean(axis=0)

    @cached_property
    def segment_lengths(self):
        """Length of each individual dipole segment."""
        return np.linalg.norm(np.diff(self.points, axis=0), axis=1)

    @property
    def length(self):
        """Total length of all dipole segments."""
        if not hasattr(self, "_length"):
            self._length = self.segment_lengths.sum()
        return self._length

    @property
    def segment_n(self):
        """Number of dipole segments."""
        return len(self.segment_lengths)

    @cached_property
    def _prefix(self):
        """Survey dict key prefix, e.g. TxED for TxElectricDipole."""
        name = type(self).__name__
        caps = [c for c in name if c.isupper()]
        return name[:2] + "".join(caps[1:])


class Point(Wire):
    """A point electrode: (x, y, z, azimuth, elevation).

    Reference: emg3d/electrodes.py:208-262.
    """

    def __init__(self, coordinates):
        if len(coordinates) != 5:
            raise ValueError(
                "Point coordinates must be defined as (x, y, z, azimuth, "
                f"elevation). Provided coordinates: {coordinates}.")
        self._coordinates = np.asarray(
            coordinates, dtype=np.float64).squeeze()
        super().__init__(coordinates[:3])

    def __repr__(self):
        head = f"{type(self).__name__}: {getattr(self, '_repr_add', '')}"
        x, y, z = self.center
        return _fmt_repr(
            head, f"x={x:,.1f} m, y={y:,.1f} m, z={z:,.1f} m, ",
            f"θ={self.azimuth:.1f}°, φ={self.elevation:.1f}°")

    @property
    def azimuth(self):
        """Anticlockwise rotation (°) from x-axis towards y-axis."""
        return self._coordinates[3]

    @property
    def elevation(self):
        """Anticlockwise (upwards) rotation (°) from the xy-plane."""
        return self._coordinates[4]


class Dipole(Wire):
    """A dipole: two electrodes on a straight line.

    Three accepted coordinate formats (emg3d/electrodes.py:264-413):
    ``[[x1,y1,z1],[x2,y2,z2]]``, ``(x1,x2,y1,y2,z1,z2)``, or
    ``(x,y,z,azimuth,elevation)`` with ``length``.  Magnetic dipoles are
    represented internally as a square loop perpendicular to the dipole.
    """

    def __init__(self, coordinates, length=1.0):
        coo = np.asarray(coordinates, dtype=np.float64).squeeze()
        magnetic = self.xtype == "magnetic"

        if coo.shape == (5,):
            # Center + angles + length.
            self._serialize = {"length"} | self._serialize
            self._coordinates = coo
            self._length = length
            points = (point_to_square_loop(coo, length) if magnetic
                      else point_to_dipole(coo, length))

        elif coo.shape in ((6,), (2, 3)):
            # Two endpoints, flat (Fortran-ordered) or stacked.
            points = coo.reshape((2, 3), order="F") if coo.ndim == 1 else coo
            self._coordinates = coo
            if np.allclose(points[0], points[1]):
                raise ValueError(
                    "The two electrodes are identical, use the format "
                    "(x, y, z, azimuth, elevation) instead. "
                    f"Provided coordinates: {coordinates}.")
            if magnetic:
                azimuth, elevation, length = dipole_to_point(points)
                center = points.mean(axis=0)
                points = point_to_square_loop(
                    (*center, azimuth, elevation), length)

        else:
            raise ValueError(
                "Dipole coordinates must be a point "
                "(x, y, z, azimuth, elevation) or two points "
                "(x1, x2, y1, y2, z1, z2) / [[x1, y1, z1], [x2, y2, z2]]. "
                f"Provided coordinates: {coordinates}.")

        super().__init__(points)

    def __repr__(self):
        head = f"{type(self).__name__}: {getattr(self, '_repr_add', '')}"
        if self.coordinates.size == 5:
            return _fmt_repr(
                head, _fmt_center(self.center),
                f"θ={self.azimuth:.1f}°, φ={self.elevation:.1f}°; "
                f"l={self.length:,.1f} m")
        e1, e2 = np.asarray(self.coordinates,
                            dtype=float).reshape((2, 3), order="F" if
                                                 self.coordinates.ndim == 1
                                                 else "C")
        return _fmt_repr(
            head,
            f"e1={{{e1[0]:,.1f}; {e1[1]:,.1f}; {e1[2]:,.1f}}} m; ",
            f"e2={{{e2[0]:,.1f}; {e2[1]:,.1f}; {e2[2]:,.1f}}} m")

    @cached_property
    def _angles(self):
        if len(self.coordinates) == 5:
            return tuple(self._coordinates[3:])
        return dipole_to_point(self._points)[:2]

    @property
    def azimuth(self):
        """Anticlockwise rotation (°) from x-axis towards y-axis."""
        return self._angles[0]

    @property
    def elevation(self):
        """Anticlockwise (upwards) rotation (°) from the xy-plane."""
        return self._angles[1]


class Source(Wire):
    """A wire with a source strength (reference: electrodes.py:415-449)."""

    _serialize = {"strength"} | Wire._serialize

    def __init__(self, strength, **kwargs):
        self._strength = strength
        self._repr_add = f"{strength:,.1f} A;"
        super().__init__(**kwargs)

    @property
    def strength(self):
        """Source strength (A)."""
        return self._strength

    def get_field(self, grid, frequency):
        """Return the source field for given grid and frequency."""
        from emg3d_tpu_torch import fields
        return fields.get_source_field(grid, self, frequency)


@utils._known_class
class TxElectricPoint(Source, Point):
    """Electric point source; (x, y, z, azimuth, elevation)."""

    def __init__(self, coordinates, strength=1.0):
        super().__init__(coordinates=coordinates, strength=strength)


@utils._known_class
class TxMagneticPoint(Source, Point):
    """Magnetic point source (infinitesimal magnetic dipole)."""

    def __init__(self, coordinates, strength=1.0):
        super().__init__(coordinates=coordinates, strength=strength)


@utils._known_class
class TxElectricDipole(Source, Dipole):
    """Electric dipole source: two electrodes connected by a wire."""

    def __init__(self, coordinates, strength=1.0, length=1.0):
        super().__init__(coordinates=coordinates, strength=strength,
                         length=length)


@utils._known_class
class TxMagneticDipole(Source, Dipole):
    """Magnetic dipole source: square loop perpendicular to the dipole."""

    def __init__(self, coordinates, strength=1.0, length=1.0):
        super().__init__(coordinates=coordinates, strength=strength,
                         length=length)


@utils._known_class
class TxElectricWire(Source, Wire):
    """Electric wire source: a series of connected dipole segments."""

    def __init__(self, coordinates, strength=1.0):
        super().__init__(coordinates=coordinates, strength=strength)


class Receiver(Wire):
    """A receiver; absolute or relative-to-source positioning.

    Reference: emg3d/electrodes.py:594-660.
    """

    _serialize = {"relative", "data_type"} | Wire._serialize

    def __init__(self, relative, data_type, **kwargs):
        if data_type.lower() != "complex":
            raise ValueError(f"Unknown data type '{data_type}'.")
        self._relative = relative
        self._data_type = data_type.lower()
        kind = "relative" if relative else "absolute"
        self._repr_add = f"{kind}; {self._data_type};"
        super().__init__(**kwargs)

    @property
    def relative(self):
        """True if coordinates are relative to the source center."""
        return self._relative

    @property
    def data_type(self):
        """Data type of the measured responses."""
        return self._data_type

    def center_abs(self, source):
        """Return the center as an absolute position."""
        return self.center + (source.center if self.relative else 0.0)

    def coordinates_abs(self, source):
        """Return the coordinates as absolute positions."""
        if hasattr(self, "azimuth"):
            return (*self.center_abs(source), self.azimuth, self.elevation)
        return self.center_abs(source)


@utils._known_class
class RxElectricPoint(Receiver, Point):
    """Electric point receiver [V/m]."""

    def __init__(self, coordinates, relative=False, data_type="complex"):
        super().__init__(coordinates=coordinates, relative=relative,
                         data_type=data_type)


@utils._known_class
class RxMagneticPoint(Receiver, Point):
    """Magnetic point receiver [A/m]."""

    def __init__(self, coordinates, relative=False, data_type="complex"):
        super().__init__(coordinates=coordinates, relative=relative,
                         data_type=data_type)


# Adjoint sources for the adjoint-state gradient
# (reference: emg3d/electrodes.py:683,715).
RxElectricPoint._adjoint_source = TxElectricPoint
RxMagneticPoint._adjoint_source = TxMagneticPoint


# -------------------------------------------------------------------------
# Geometry helpers (reference: emg3d/electrodes.py:726-872).
# -------------------------------------------------------------------------

def point_to_dipole(point, length, deg=True):
    """Dipole endpoints from center point, angles, and length."""
    half = rotation(point[3], point[4], deg=deg) * (length / 2)
    return np.stack([point[:3] - half, point[:3] + half])


def dipole_to_point(dipole, deg=True):
    """Azimuth, elevation, and length of an electrode pair."""
    dx, dy, dz = dipole[1] - dipole[0]
    horiz = np.hypot(dx, dy)
    azimuth = np.angle(complex(dx, dy), deg=deg)
    elevation = np.angle(complex(horiz, dz), deg=deg)
    return azimuth, elevation, np.hypot(horiz, dz)


def point_to_square_loop(source, area):
    """Closed square loop of given area, perpendicular to the source dipole.

    Returns five points (closed rectangle).
    """
    half_diag = np.sqrt(area / 2)
    hor = rotation(source[3] + 90.0, 0.0) * half_diag
    ver = rotation(source[3], source[4] + 90.0) * half_diag
    return source[:3] + np.stack([hor, ver, -hor, -ver, hor])


def rotation(azimuth, elevation, deg=True):
    """Rotation factors for a RHS coordinate system with positive z upwards.

    azimuth: anticlockwise from x towards y; elevation: upwards from the
    xy-plane towards z (reference: emg3d/electrodes.py:825-872).
    """
    cos, sin = (sp.special.cosdg, sp.special.sindg) if deg else (
        np.cos, np.sin)
    return np.array([cos(azimuth) * cos(elevation),
                     sin(azimuth) * cos(elevation),
                     sin(elevation)])
