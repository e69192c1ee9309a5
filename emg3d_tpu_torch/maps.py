"""Property mappings and grid-to-grid / grid-to-points interpolation.

Copy of ``emg3d_tpu.maps`` for the PyTorch port (numpy only; the text
below speaks of the JAX package it was written for).
Rebuild of the reference's emg3d/maps.py.

- The six mapping classes (maps.py:52-229 in the reference) are plain
  function pairs; they work on numpy and jax arrays alike.
- ``interpolate`` (reference maps.py:232-497) is host-side: regridding is
  setup-time work between solves, not part of the jitted compute path.
- The volume-average regridding (reference's numba kernels
  ``interp_volume_average``/``_volume_average_weights``, maps.py:555-664) is
  implemented as *vectorized numpy* (np.add.at scatter) — no scalar loops.
- ``interp_edges_to_vol_averages`` (reference maps.py:667-719) and the
  regridding adjoints are host-side numpy: gradient assembly happens once
  per solve, outside the hot device loop.
"""

import numpy as np
import scipy as sp

__all__ = [
    "BaseMap", "MapConductivity", "MapLgConductivity", "MapLnConductivity",
    "MapResistivity", "MapLgResistivity", "MapLnResistivity", "interpolate",
    "interp_spline_3d", "interp_volume_average",
    "interp_edges_to_vol_averages", "interp_volume_average_adj",
    "edge_product_deriv_times_vector", "ellipse_indices", "register_map",
]


def __dir__():
    return __all__


# Registry for custom maps (reference: maps.py register_map).
MAPLIST = {}


def register_map(cls):
    """Register a map class so the I/O layer can instantiate it by name."""
    MAPLIST[cls.__name__] = cls
    return cls


class BaseMap:
    """Maps an investigation variable `x` to conductivity (the solver var).

    Subclasses implement ``forward`` (conductivity -> x), ``backward``
    (x -> conductivity), and ``derivative_chain`` (in-place chain rule for
    gradients).  Mirrors emg3d/maps.py:52-101.
    """

    def __init__(self, description):
        self.name = self.__class__.__name__[3:]
        self.description = description

    def __repr__(self):
        return (f"{self.__class__.__name__}: {self.description}\n"
                "    Maps investigation variable `x` to\n"
                "    computational variable `σ` (conductivity).")

    def forward(self, conductivity):
        """Conductivity to mapped property."""
        raise NotImplementedError("Forward map not implemented.")

    def backward(self, mapped):
        """Mapped property to conductivity."""
        raise NotImplementedError("Backward map not implemented.")

    def derivative_chain(self, gradient, mapped):
        """In-place chain rule from conductivity- to mapped-space gradient."""
        raise NotImplementedError("Derivative chain not implemented.")


@register_map
class MapConductivity(BaseMap):
    """x = sigma."""

    def __init__(self):
        super().__init__("conductivity")

    def forward(self, conductivity):
        return conductivity

    def backward(self, mapped):
        return mapped

    def derivative_chain(self, gradient, mapped):
        pass


@register_map
class MapLgConductivity(BaseMap):
    """x = log_10(sigma)."""

    def __init__(self):
        super().__init__("log_10(conductivity)")

    def forward(self, conductivity):
        return np.log10(conductivity)

    def backward(self, mapped):
        return 10 ** mapped

    def derivative_chain(self, gradient, mapped):
        gradient *= self.backward(mapped) * np.log(10)


@register_map
class MapLnConductivity(BaseMap):
    """x = log_e(sigma)."""

    def __init__(self):
        super().__init__("log_e(conductivity)")

    def forward(self, conductivity):
        return np.log(conductivity)

    def backward(self, mapped):
        return np.exp(mapped)

    def derivative_chain(self, gradient, mapped):
        gradient *= self.backward(mapped)


@register_map
class MapResistivity(BaseMap):
    """x = rho = 1/sigma."""

    def __init__(self):
        super().__init__("resistivity")

    def forward(self, conductivity):
        return 1.0 / conductivity

    def backward(self, mapped):
        return 1.0 / mapped

    def derivative_chain(self, gradient, mapped):
        gradient *= -self.backward(mapped) ** 2


@register_map
class MapLgResistivity(BaseMap):
    """x = log_10(rho)."""

    def __init__(self):
        super().__init__("log_10(resistivity)")

    def forward(self, conductivity):
        return np.log10(1.0 / conductivity)

    def backward(self, mapped):
        return 10 ** -mapped

    def derivative_chain(self, gradient, mapped):
        gradient *= -self.backward(mapped) * np.log(10)


@register_map
class MapLnResistivity(BaseMap):
    """x = log_e(rho)."""

    def __init__(self):
        super().__init__("log_e(resistivity)")

    def forward(self, conductivity):
        return np.log(1.0 / conductivity)

    def backward(self, mapped):
        return np.exp(-mapped)

    def derivative_chain(self, gradient, mapped):
        gradient *= -self.backward(mapped)


# -------------------------------------------------------------------------
# Interpolation (host-side; reference maps.py:232-552).
# -------------------------------------------------------------------------

def interpolate(grid, values, xi, method="linear", extrapolate=True,
                log=False, **kwargs):
    """Interpolate ``values`` from ``grid`` to a new grid or to points.

    Methods: 'nearest'/'linear' (RegularGridInterpolator), 'cubic'
    (spline via map_coordinates, see :func:`interp_spline_3d`), and
    'volume' (conservative volume averaging; cell-centered values and
    grid-target only).  ``log=True`` interpolates on log10 scale.
    Mirrors emg3d/maps.py:232-497.
    """
    values = np.asarray(values)
    if log:
        values = np.log10(values)

    points, new_points, shape = _points_from_grids(grid, values, xi, method)

    if method == "volume":
        values_x = np.zeros(shape, dtype=values.dtype)
        interp_volume_average(
            nodes_x=points[0], nodes_y=points[1], nodes_z=points[2],
            values=values, new_nodes_x=new_points[0],
            new_nodes_y=new_points[1], new_nodes_z=new_points[2],
            new_values=values_x,
            new_vol=xi.cell_volumes_3d if hasattr(xi, "cell_volumes_3d")
            else np.asarray(xi.cell_volumes).reshape(shape, order="F"))

    elif method == "cubic":
        opts = {"mode": "nearest" if extrapolate else "constant", **kwargs}
        values_x = interp_spline_3d(
            points=points, values=values, xi=new_points, **opts)

    else:  # 'nearest' / 'linear'.
        opts = {"bounds_error": False,
                "fill_value": None if extrapolate else 0.0, **kwargs}
        values_x = sp.interpolate.RegularGridInterpolator(
            points=points, values=values, method=method, **opts)(
                xi=new_points)

    if log:
        values_x = 10 ** values_x

    return values_x.reshape(shape, order="F")


def _points_from_grids(grid, values, xi, method):
    """Return input points, output points, and output shape.

    Mirrors emg3d/maps.py:500-552 (reference `_points_from_grids`).
    """
    if method == "volume":
        if not hasattr(xi, "nodes_x"):
            raise ValueError("``method='volume'`` is only implemented for "
                             "TensorMesh instances as input for ``xi``.")
        if tuple(grid.shape_cells) != values.shape:
            raise ValueError(
                "``method='volume'`` is only implemented for cell-centered "
                f"properties; required shape = {grid.shape_cells}.")
    else:
        valid = [grid.shape_edges_x, grid.shape_faces_y, grid.shape_edges_z,
                 grid.shape_faces_x, grid.shape_edges_y, grid.shape_faces_z,
                 grid.shape_cells]
        if tuple(values.shape) not in [tuple(v) for v in valid]:
            raise ValueError(
                "``values`` must be a 3D ndarray living on cell centers, "
                "edges, or faces of the ``grid``.")

    # Electric flag: living on edges (or cells) vs living on faces.
    electric = tuple(values.shape) not in [
        tuple(grid.shape_faces_x), tuple(grid.shape_edges_y),
        tuple(grid.shape_faces_z)]

    xi_is_grid = hasattr(xi, "nodes_x")

    points = ()
    new_points = ()
    shape = ()
    for i, coord in enumerate("xyz"):
        comp_shape = [grid.shape_cells[i], grid.shape_nodes[i]][electric]
        if method == "volume" or values.shape[i] == comp_shape:
            prop = ["cell_centers_", "nodes_"][electric]
        else:
            prop = ["nodes_", "cell_centers_"][electric]
        points += (getattr(grid, prop + coord),)
        if xi_is_grid:
            pts = getattr(xi, prop + coord)
            new_points += (pts,)
            shape += (len(pts),)

    if method != "volume":
        if xi_is_grid:
            xx, yy, zz = np.broadcast_arrays(
                new_points[0][:, None, None], new_points[1][:, None],
                new_points[2])
            new_points = np.r_[xx.ravel("F"), yy.ravel("F"), zz.ravel("F")]
            new_points = new_points.reshape(-1, 3, order="F")
        else:
            # Points: either a tuple of (broadcastable) coordinate arrays
            # or an (..., 3) array.
            if isinstance(xi, tuple):
                coords = np.broadcast_arrays(
                    *[np.asarray(c, dtype=np.float64) for c in xi])
                new_points = np.stack(coords, axis=-1)
            else:
                new_points = np.asarray(xi, dtype=np.float64)
            shape = new_points.shape[:-1]
            new_points = new_points.reshape(-1, 3, order="F")
    else:
        shape = tuple(xi.shape_cells)

    return points, new_points, shape


def interp_spline_3d(points, values, xi, **kwargs):
    """Cubic-spline 3-D interpolation via the map_coordinates trick.

    Maps the tensor-grid coordinates to regular indices with 1-D cubic
    splines, then evaluates with :func:`scipy.ndimage.map_coordinates`
    (reference: emg3d/maps.py:500-552).
    """
    coords = np.empty(xi.T.shape)
    for i in range(3):
        coords[i] = sp.interpolate.interp1d(
            points[i], np.arange(len(points[i])), kind="cubic",
            bounds_error=False, fill_value="extrapolate")(xi[:, i])
    return sp.ndimage.map_coordinates(values, coords, **kwargs)


def _volume_average_weights(x_i, x_o):
    """1-D weights/indices for conservative volume averaging — vectorized.

    Numpy re-expression of the reference's numba scan
    (emg3d/maps.py:619-664): merge the two node vectors, take each merged
    sub-interval whose center falls inside the output grid, and map it to
    its enclosing input and output cell (nearest cell outside the input
    grid, i.e. constant extrapolation).
    """
    xs = np.unique(np.concatenate((x_i, x_o)))
    centers = 0.5 * (xs[:-1] + xs[1:])
    mask = (centers >= x_o[0]) & (centers <= x_o[-1])
    centers = centers[mask]
    w = np.diff(xs)[mask]
    ix_i = np.clip(np.searchsorted(x_i, centers, side="right") - 1,
                   0, x_i.size - 2)
    ix_o = np.clip(np.searchsorted(x_o, centers, side="right") - 1,
                   0, x_o.size - 2)
    return w, ix_i.astype(np.int64), ix_o.astype(np.int64)


def interp_volume_average(nodes_x, nodes_y, nodes_z, values, new_nodes_x,
                          new_nodes_y, new_nodes_z, new_values, new_vol):
    """Conservative volume-average regridding of cell properties.

    Vectorized scatter-add version of the reference's numba kernel
    (emg3d/maps.py:555-616; discretize/Capriotti algorithm).  The result is
    added to ``new_values`` and normalized by the new cell volumes.
    """
    wx, ixi, ixo = _volume_average_weights(nodes_x, new_nodes_x)
    wy, iyi, iyo = _volume_average_weights(nodes_y, new_nodes_y)
    wz, izi, izo = _volume_average_weights(nodes_z, new_nodes_z)

    # Outer product of contributions; scatter-add into the output cells.
    contrib = (wx[:, None, None] * wy[None, :, None] * wz[None, None, :]
               * values[np.ix_(ixi, iyi, izi)])
    np.add.at(new_values, np.ix_(ixo, iyo, izo), contrib)
    new_values /= new_vol
    return new_values


def interp_edges_to_vol_averages(ex, ey, ez, volumes, ox, oy, oz):
    """Edge fields -> cell-centered volume-weighted values (numpy version).

    Each cell receives 1/4 of each of its four parallel edges, weighted by
    the cell volume; used to assemble gradients (reference:
    emg3d/maps.py:667-719).  Vectorized; adds to ``ox``, ``oy``, ``oz``.
    Host-side by design: runs once per solve, outside the device loop.
    """
    # ex has shape (nx, ny+1, nz+1); cell (ix, iy, iz) sees edges
    # (ix, iy:iy+2, iz:iz+2).
    ox += volumes * (ex[:, :-1, :-1] + ex[:, 1:, :-1]
                     + ex[:, :-1, 1:] + ex[:, 1:, 1:]) / 4
    oy += volumes * (ey[:-1, :, :-1] + ey[1:, :, :-1]
                     + ey[:-1, :, 1:] + ey[1:, :, 1:]) / 4
    oz += volumes * (ez[:-1, :-1, :] + ez[1:, :-1, :]
                     + ez[:-1, 1:, :] + ez[1:, 1:, :]) / 4


def interp_volume_average_adj(oval, ogrid, nval, ngrid):
    """In-place adjoint of conservative volume averaging.

    The reference delegates to discretize (emg3d/maps.py:723-756); here
    the adjoint is assembled natively from the same merged-node weights
    as the forward map: forward is ``new[o] = Σ_i w_io val[i] / V_n[o]``,
    so the adjoint is ``oval[i] += Σ_o w_io nval[o] / V_n[o]``.

    ``oval``/``nval`` have shape (3, \\*grid.shape_cells); used to bring
    adjoint-state gradients from computational grids back to the
    inversion grid (reference simulations.py:1064-1067).
    """
    wx, ixi, ixo = _volume_average_weights(ogrid.nodes_x, ngrid.nodes_x)
    wy, iyi, iyo = _volume_average_weights(ogrid.nodes_y, ngrid.nodes_y)
    wz, izi, izo = _volume_average_weights(ogrid.nodes_z, ngrid.nodes_z)

    vol_n = ngrid.cell_volumes.reshape(ngrid.shape_cells, order="F")
    for c in range(oval.shape[0]):
        scaled = nval[c] / vol_n
        contrib = (wx[:, None, None] * wy[None, :, None]
                   * wz[None, None, :] * scaled[np.ix_(ixo, iyo, izo)])
        np.add.at(oval[c], np.ix_(ixi, iyi, izi), contrib)
    return oval


def edge_product_deriv_times_vector(efield, cell_values):
    """G·v: derivative of the system's σ-term times a model vector.

    The reference computes this with discretize's
    ``get_edge_inner_product_deriv`` (emg3d/simulations.py:1357-1360).
    Natively: the σ-term couples each edge to the average of its (up to
    four) adjacent cells' V·σ/4, so (∂S/∂σ · v)E at an edge is the edge
    field times the 4-cell average of V·v — the exact adjoint of
    :func:`interp_edges_to_vol_averages`.

    Parameters
    ----------
    efield : Field
        Electric (forward) field.
    cell_values : ndarray or tuple of 3 ndarrays
        V-weighted model vector per cell; a single array for isotropic,
        or (vx, vy, vz) for anisotropic cases.

    Returns
    -------
    data : ndarray
        Edge-shaped 1-D array (Field-data layout) of G·v applied to E.
    """
    if not isinstance(cell_values, (tuple, list)):
        cell_values = (cell_values,) * 3

    grid = efield.grid
    shape = grid.shape_cells
    vol = grid.cell_volumes.reshape(shape, order="F")

    def cells_to_edges(v, axis):
        """Scatter cell values to the 4 parallel edges (1/4 each)."""
        pads = [(0, 0), (0, 0), (0, 0)]
        pads[(axis + 1) % 3] = (1, 1)
        pads[(axis + 2) % 3] = (1, 1)
        p = np.pad(v, pads)
        if axis == 0:
            return (p[:, :-1, :-1] + p[:, 1:, :-1]
                    + p[:, :-1, 1:] + p[:, 1:, 1:]) / 4.0
        if axis == 1:
            return (p[:-1, :, :-1] + p[1:, :, :-1]
                    + p[:-1, :, 1:] + p[1:, :, 1:]) / 4.0
        return (p[:-1, :-1, :] + p[1:, :-1, :]
                + p[:-1, 1:, :] + p[1:, 1:, :]) / 4.0

    gx = efield.fx * cells_to_edges(vol * cell_values[0], 0)
    gy = efield.fy * cells_to_edges(vol * cell_values[1], 1)
    gz = efield.fz * cells_to_edges(vol * cell_values[2], 2)
    return np.r_[gx.ravel('F'), gy.ravel('F'), gz.ravel('F')]


def ellipse_indices(coo, p0, p1, radius, factor=1.0, minor=1.0,
                    check_foci=True):
    """Return boolean mask of points inside a general ellipse around p0-p1.

    Reference: emg3d/maps.py:760-884 (`ellipse_indices`).
    """
    cx = (p0[0] + p1[0]) / 2.0
    cy = (p0[1] + p1[1]) / 2.0
    dx = (p1[0] - p0[0]) / 2.0
    dy = (p1[1] - p0[1]) / 2.0
    dxy = np.linalg.norm([dx, dy])

    if dy == 0.0:
        cos, sin = 1.0, 0.0
    else:
        cos, sin = dx / dxy, dy / dxy

    minimum_axis = 1e-9
    major = max(dxy * factor, dxy + radius, minimum_axis)
    minor = max(minor * major, radius, minimum_axis)
    if check_foci:
        minor = max(minor, np.sqrt(abs(major ** 2 - dxy ** 2)), minimum_axis)

    X, Y = coo[0] - cx, coo[1] - cy
    A = (cos / major) ** 2 + (sin / minor) ** 2
    B = 2 * cos * sin * (major ** -2 - minor ** -2)
    C = (sin / major) ** 2 + (cos / minor) ** 2
    if X.ndim == 1:
        return A * X[:, None] ** 2 + B * np.outer(X, Y) \
            + C * Y[None, :] ** 2 <= 1.0
    return A * X ** 2 + B * X * Y + C * Y ** 2 <= 1.0
