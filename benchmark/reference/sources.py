"""Electric point sources, in plain NumPy.

A point source as emg3d defines it (``TxElectricPoint``): the trilinear
weights of its position on the eight edges around it, for each field
component, weighted by its orientation and times ``-s mu_0`` and its
strength.
"""

import numpy as np
from scipy.special import cosdg, sindg

from benchmark.reference.maxwell import smu0

__all__ = ["orientation", "point_field"]


def orientation(azimuth, elevation):
    """Unit vector of a dipole from its azimuth and elevation (degrees)."""
    return np.array([cosdg(azimuth) * cosdg(elevation),
                     sindg(azimuth) * cosdg(elevation),
                     sindg(elevation)])


def _weights(coords, x):
    """(i, (1 - r, r)): x lies between coords[i] and coords[i + 1]."""
    i = int(np.searchsorted(coords, x, side="right")) - 1
    if not 0 <= i < len(coords) - 1:
        raise ValueError(f"position {x} is outside {coords[0]}-"
                         f"{coords[-1]}")
    r = (x - coords[i]) / (coords[i + 1] - coords[i])
    return i, (1.0 - r, r)


def _corners(grid, component, xyz):
    """The 8 (index, weight) pairs of trilinear interpolation at ``xyz``
    on the edges of field ``component``."""
    axes = [_weights(c, x) for c, x in
            zip(grid.edge_coordinates(component), xyz)]
    out = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = (axes[0][0] + dx, axes[1][0] + dy, axes[2][0] + dz)
                out.append((idx, axes[0][1][dx] * axes[1][1][dy]
                            * axes[2][1][dz]))
    return out


def point_field(grid, xyz, direction, strength, frequency):
    """The field of a point source at ``xyz``: three complex arrays of
    the edge shapes."""
    out = tuple(np.zeros(s, dtype=complex) for s in grid.edge_shapes())
    scale = -smu0(frequency) * strength
    for c in range(3):
        if abs(direction[c]) <= 1e-10:
            continue
        for idx, w in _corners(grid, c, xyz):
            out[c][idx] += scale * direction[c] * w
    return out
