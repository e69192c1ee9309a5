"""Fields: electric/magnetic field container, source fields, receivers.

Copy of ``emg3d_tpu.fields`` for the PyTorch port (numpy only), without
``get_magnetic_field``; rebuild of the reference's emg3d/fields.py.

The ``Field`` container keeps the reference's layout (one 1-D array over all
edges with Fortran-ordered 3-D views, emg3d/fields.py:40-383) for I/O and
API parity; the solver converts the three components to device arrays once
per solve.  Source-field construction and receiver sampling are host-side
setup work (numpy).

Notable deviation: the magnetic point source (_point_vector_magnetic) is
implemented natively (adjoint trilinear onto faces + transposed edge-curl)
instead of via discretize (reference fields.py:748-789).
"""

import warnings
from copy import deepcopy

import numpy as np
import scipy as sp

from emg3d_tpu_torch import config, electrodes, maps, meshes, utils

__all__ = ["Field", "get_source_field", "get_receiver"]


def __dir__():
    return __all__


@utils._known_class
class Field:
    """Container for x-, y-, and z-directed electromagnetic fields.

    One 1-D array ``field`` holding [fx, fy, fz] (Fortran-raveled each),
    with 3-D views ``fx``/``fy``/``fz``.  Electric fields live on edges,
    magnetic fields on faces (reference fields.py:40-383).

    dtype convention (reference fields.py:93-102): frequency > 0 ->
    complex (s = i*2*pi*f); frequency < 0 -> real (Laplace, s = -f).
    """

    def __init__(self, grid, data=None, frequency=None, dtype=None,
                 electric=True):
        if frequency is not None:
            dtype = config.solve_dtype(frequency)
            if np.issubdtype(dtype, np.floating) and frequency == 0:
                raise ValueError(
                    "`frequency` must be f>0 (frequency domain) or f<0 "
                    f"(Laplace domain). Provided: {frequency} Hz.")
        elif data is not None:
            dtype = np.asarray(data).dtype
        elif dtype is None:
            dtype = np.complex128

        self.grid = grid
        self._frequency = frequency
        self.electric = electric

        if data is None:
            field = np.zeros(self._get_prop("n"), dtype=dtype)
        else:
            field = np.asarray(data, dtype=dtype).ravel()
        self._field = utils.EMArray(field)

    def __repr__(self):
        return (f"{self.__class__.__name__}: "
                f"{['magnetic', 'electric'][self.electric]}; "
                f"{self.grid.shape_cells[0]} x {self.grid.shape_cells[1]} x "
                f"{self.grid.shape_cells[2]}; {self.field.size:,}")

    def __eq__(self, field):
        equal = self.__class__.__name__ == field.__class__.__name__
        equal *= self.grid == field.grid
        equal *= self._frequency == field._frequency
        equal *= self.electric == field.electric
        if equal:
            equal *= np.allclose(self._field, field._field, atol=0,
                                 rtol=1e-10)
        return bool(equal)

    def copy(self):
        """Return a copy of the Field."""
        return self.from_dict(self.to_dict(copy=True))

    def to_dict(self, copy=False):
        """Store the necessary information in a dict."""
        out = {
            "__class__": self.__class__.__name__,
            "grid": meshes.TensorMesh(
                self.grid.h, self.grid.origin).to_dict(),
            "data": np.asarray(self._field),
            "frequency": self._frequency,
            "electric": self.electric,
        }
        return deepcopy(out) if copy else out

    @classmethod
    def from_dict(cls, inp):
        """Re-create a Field from a dict as given by ``to_dict``."""
        inp = {k: v for k, v in inp.items() if k != "__class__"}
        grid = inp.pop("grid")
        if isinstance(grid, dict):  # io may have deserialized it already.
            MeshClass = getattr(
                meshes, grid.get("__class__", "TensorMesh"))
            grid = MeshClass.from_dict(grid)
        return cls(grid=grid, **inp)

    # Data access -------------------------------------------------------------

    @property
    def field(self):
        """Entire field as 1-D array [fx, fy, fz]."""
        return self._field

    @field.setter
    def field(self, field):
        self._field[:] = field

    @property
    def fx(self):
        """Field in x-direction; 3-D (Fortran-ordered) view."""
        i1 = self._get_prop("n", "x")
        return self._field[:i1].reshape(self._get_prop("shape", "x"),
                                        order="F")

    @fx.setter
    def fx(self, fx):
        i1 = self._get_prop("n", "x")
        self._field[:i1] = np.asarray(fx).ravel("F")

    @property
    def fy(self):
        """Field in y-direction; 3-D (Fortran-ordered) view."""
        i0, i1 = self._get_prop("n", "x"), self._get_prop("n", "z")
        return self._field[i0:-i1].reshape(self._get_prop("shape", "y"),
                                           order="F")

    @fy.setter
    def fy(self, fy):
        i0, i1 = self._get_prop("n", "x"), self._get_prop("n", "z")
        self._field[i0:-i1] = np.asarray(fy).ravel("F")

    @property
    def fz(self):
        """Field in z-direction; 3-D (Fortran-ordered) view."""
        i0 = self._get_prop("n", "z")
        return self._field[-i0:].reshape(self._get_prop("shape", "z"),
                                         order="F")

    @fz.setter
    def fz(self, fz):
        i0 = self._get_prop("n", "z")
        self._field[-i0:] = np.asarray(fz).ravel("F")

    @property
    def frequency(self):
        """Frequency (Hz)."""
        if self._frequency is None:
            return None
        return abs(self._frequency)

    @property
    def smu0(self):
        """s * mu_0."""
        if self.sval is None:
            return None
        return self.sval * sp.constants.mu_0

    @property
    def sval(self):
        """Laplace parameter: s = i*omega (f-domain), s = -f (s-domain)."""
        if self._frequency is None:
            return None
        if self._frequency < 0:
            return np.array(-self._frequency)
        return np.array(2j * np.pi * self._frequency)

    def _get_prop(self, pre=None, post=None):
        """Return an `edges`/`faces` grid attribute based on `electric`."""
        name = "" if pre is None else pre + "_"
        name += "edges" if self.electric else "faces"
        name += "" if post is None else "_" + post
        return getattr(self.grid, name)

    # Interpolation -----------------------------------------------------------

    def interpolate_to_grid(self, grid, **interpolate_opts):
        """Interpolate the field to a new grid (default: cubic splines).

        Reference: emg3d/fields.py:303-346.
        """
        if grid == self.grid:
            return self

        g2g_inp = {
            "method": "cubic",
            "extrapolate": False,
            "log": False,
            **(interpolate_opts or {}),
            "grid": self.grid,
            "xi": grid,
        }

        field = np.r_[
            maps.interpolate(values=self.fx, **g2g_inp).ravel("F"),
            maps.interpolate(values=self.fy, **g2g_inp).ravel("F"),
            maps.interpolate(values=self.fz, **g2g_inp).ravel("F")]

        return Field(grid, field, frequency=self._frequency)

    def get_receiver(self, receiver, method="cubic"):
        """Return the field response at receiver coordinates."""
        return get_receiver(self, receiver, method)


def get_source_field(grid, source, frequency, **kwargs):
    """Return the source field -i*omega*mu_0*J_s for source and frequency.

    Dipoles/wires distribute the source as length-fraction per cell; points
    use the adjoint of trilinear interpolation (reference
    fields.py:386-519).
    """
    # Convert tuples/lists/ndarrays to source instances.
    if isinstance(source, (tuple, list, np.ndarray)):
        inp = {"strength": kwargs.get("strength", 1.0)}
        source = np.asarray(source)
        if source.size == 5:
            inp["length"] = kwargs.get("length", 1.0)
        if source.size > 6:
            source = electrodes.TxElectricWire(source, **inp)
        elif kwargs.get("electric", True):
            source = electrodes.TxElectricDipole(source, **inp)
        else:
            source = electrodes.TxMagneticDipole(source, **inp)

    # Get the geometric vector field.
    if isinstance(source, electrodes.TxElectricPoint):
        vfield = _point_vector(grid, source.coordinates)
    elif isinstance(source, electrodes.TxMagneticPoint):
        vfield = _point_vector_magnetic(grid, source.coordinates, frequency)
    else:
        vfield = _dipole_vector(grid, source.points)

    sfield = Field(grid, data=vfield.field, frequency=frequency)
    sfield.field = sfield.field * source.strength
    if frequency is not None:
        sfield.field = sfield.field * (-sfield.smu0)

    return sfield


def get_receiver(field, receiver, method="cubic"):
    """Return the field response at receiver coordinates.

    Cubic/linear interpolation with rotation factors for oriented
    receivers; NaN outside the grid or in the outermost (PEC-adjacent)
    cells (reference fields.py:522-614).
    """
    if hasattr(receiver, "coordinates"):
        coordinates = receiver.coordinates
    elif hasattr(tuple(receiver)[0], "coordinates"):
        nrec = len(receiver)
        coordinates = np.zeros((nrec, 5))
        for i, r in enumerate(receiver):
            coordinates[i, :] = r.coordinates
        coordinates = tuple(coordinates.T)
    else:
        coordinates = receiver
        if len(coordinates) != 5:
            raise ValueError(
                "`receiver` needs to be in the form "
                "(x, y, z, azimuth, elevation). "
                f"Length of provided `receiver`: {len(coordinates)}.")

    grid = field.grid

    _, xi, shape = maps._points_from_grids(
        grid, field.fx, coordinates[:3], "cubic")
    resp = np.zeros(xi.shape[0], dtype=field.field.dtype)

    factors = electrodes.rotation(*coordinates[3:])

    opts = {"method": method, "extrapolate": False, "log": False}
    if method == "linear":
        opts["fill_value"] = np.nan
    else:
        opts["cval"] = np.nan
    for i, ff in enumerate((field.fx, field.fy, field.fz)):
        if np.any(abs(factors[i]) > 1e-10):
            resp += factors[i] * maps.interpolate(grid, ff, xi, **opts)

    # PEC guard: receivers in the outermost cells -> NaN.
    ind = ((xi[:, 0] < grid.nodes_x[1]) | (xi[:, 0] > grid.nodes_x[-2]) |
           (xi[:, 1] < grid.nodes_y[1]) | (xi[:, 1] > grid.nodes_y[-2]) |
           (xi[:, 2] < grid.nodes_z[1]) | (xi[:, 2] > grid.nodes_z[-2]))
    resp[ind] = np.nan

    return utils.EMArray(resp.reshape(shape, order="F"))


def _point_vector(grid, coordinates):
    """Point source via the adjoint of trilinear interpolation.

    Reference: emg3d/fields.py:662-745.
    """
    outside = (
        coordinates[0] < grid.nodes_x[0] or
        coordinates[0] > grid.nodes_x[-1] or
        coordinates[1] < grid.nodes_y[0] or
        coordinates[1] > grid.nodes_y[-1] or
        coordinates[2] < grid.nodes_z[0] or
        coordinates[2] > grid.nodes_z[-1])
    if outside:
        raise ValueError(f"Provided source outside grid: {coordinates}.")

    def adjoint_interp(xx, yy, zz, coo, s):
        """Scatter unit strength to the 8 surrounding positions of coo."""
        nx, ny, nz = s.shape

        def cell_index(cc, coo_c):
            return max(0, int(np.searchsorted(np.r_[cc, np.inf], coo_c,
                                              side="right")) - 1)

        ix = cell_index(xx, coo[0])
        iy = cell_index(yy, coo[1])
        iz = cell_index(zz, coo[2])

        def frac(ic, nc, csrc, cc):
            if ic == nc - 1:
                return 1.0, 1.0, ic
            ic1 = ic + 1
            rc = (csrc - cc[ic]) / (cc[ic1] - cc[ic])
            return rc, 1.0 - rc, ic1

        rx, ex, ix1 = frac(ix, nx, coo[0], xx)
        ry, ey, iy1 = frac(iy, ny, coo[1], yy)
        rz, ez, iz1 = frac(iz, nz, coo[2], zz)

        s[ix, iy, iz] = ex * ey * ez
        s[ix1, iy, iz] = rx * ey * ez
        s[ix, iy1, iz] = ex * ry * ez
        s[ix1, iy1, iz] = rx * ry * ez
        s[ix, iy, iz1] = ex * ey * rz
        s[ix1, iy, iz1] = rx * ey * rz
        s[ix, iy1, iz1] = ex * ry * rz
        s[ix1, iy1, iz1] = rx * ry * rz

    vfield = Field(grid, dtype=float)
    fx = np.zeros(grid.shape_edges_x)
    fy = np.zeros(grid.shape_edges_y)
    fz = np.zeros(grid.shape_edges_z)

    adjoint_interp(grid.cell_centers_x, grid.nodes_y, grid.nodes_z,
                   coordinates[:3], fx)
    adjoint_interp(grid.nodes_x, grid.cell_centers_y, grid.nodes_z,
                   coordinates[:3], fy)
    adjoint_interp(grid.nodes_x, grid.nodes_y, grid.cell_centers_z,
                   coordinates[:3], fz)

    srcdir = electrodes.rotation(*coordinates[3:])
    vfield.fx = fx * srcdir[0]
    vfield.fy = fy * srcdir[1]
    vfield.fz = fz * srcdir[2]

    return vfield


def _point_vector_magnetic(grid, coordinates, frequency):
    """Magnetic point source: transposed edge-curl of a face interpolant.

    Native implementation (no discretize) of reference fields.py:748-789:
    trilinear interpolation weights onto the faces, then scatter via the
    transpose of the discrete edge-curl, divided by s*mu_0.
    """
    coords = np.asarray(coordinates, dtype=float)
    rot = electrodes.rotation(coords[3], coords[4])

    # Trilinear interpolation weights of the point onto each face grid.
    wx = _trilinear_weights(
        (grid.nodes_x, grid.cell_centers_y, grid.cell_centers_z), coords[:3])
    wy = _trilinear_weights(
        (grid.cell_centers_x, grid.nodes_y, grid.cell_centers_z), coords[:3])
    wz = _trilinear_weights(
        (grid.cell_centers_x, grid.cell_centers_y, grid.nodes_z), coords[:3])

    fx = np.zeros(grid.shape_faces_x)
    fy = np.zeros(grid.shape_faces_y)
    fz = np.zeros(grid.shape_faces_z)
    for (i, j, k), w in wx:
        fx[i, j, k] = w * rot[0]
    for (i, j, k), w in wy:
        fy[i, j, k] = w * rot[1]
    for (i, j, k), w in wz:
        fz[i, j, k] = w * rot[2]

    hx, hy, hz = grid.h

    ex = np.zeros(grid.shape_edges_x)
    ey = np.zeros(grid.shape_edges_y)
    ez = np.zeros(grid.shape_edges_z)

    # Transpose of curl_x = d_y Ez - d_z Ey on x-faces (i, j, k):
    #   Ez(i, j, k)   -= fx/hy[j];  Ez(i, j+1, k) += fx/hy[j]
    #   Ey(i, j, k)   += fx/hz[k];  Ey(i, j, k+1) -= fx/hz[k]
    ez[:, :-1, :] -= fx / hy[None, :, None]
    ez[:, 1:, :] += fx / hy[None, :, None]
    ey[:, :, :-1] += fx / hz[None, None, :]
    ey[:, :, 1:] -= fx / hz[None, None, :]

    # Transpose of curl_y = d_z Ex - d_x Ez on y-faces (i, j, k).
    ex[:, :, :-1] -= fy / hz[None, None, :]
    ex[:, :, 1:] += fy / hz[None, None, :]
    ez[:-1, :, :] += fy / hx[:, None, None]
    ez[1:, :, :] -= fy / hx[:, None, None]

    # Transpose of curl_z = d_x Ey - d_y Ex on z-faces (i, j, k).
    ey[:-1, :, :] -= fz / hx[:, None, None]
    ey[1:, :, :] += fz / hx[:, None, None]
    ex[:, :-1, :] += fz / hy[None, :, None]
    ex[:, 1:, :] -= fz / hy[None, :, None]

    vfield = Field(grid, frequency=frequency)
    vfield.fx = -ex
    vfield.fy = -ey
    vfield.fz = -ez

    if frequency is not None:
        vfield.field = vfield.field / (-vfield.smu0)

    return vfield


def _trilinear_weights(vectors, coo):
    """Return [(indices, weight), ...] of trilinear interpolation of coo.

    Constant (clamped) extrapolation outside the vectors, consistent with
    the reference's point-source behaviour.
    """
    idx, frac = [], []
    for vec, c in zip(vectors, coo):
        i = int(np.clip(np.searchsorted(vec, c) - 1, 0, vec.size - 2))
        r = (c - vec[i]) / (vec[i + 1] - vec[i])
        r = float(np.clip(r, 0.0, 1.0))
        idx.append(i)
        frac.append(r)

    out = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[0] if dx else 1 - frac[0])
                     * (frac[1] if dy else 1 - frac[1])
                     * (frac[2] if dz else 1 - frac[2]))
                if w != 0.0:
                    out.append(((idx[0] + dx, idx[1] + dy, idx[2] + dz), w))
    return out


def _dipole_vector(grid, points, decimals=9, nodes=None):
    """Finite-length dipole/wire source distributed per cell-length fraction.

    Segment walk through the grid cells (reference fields.py:792-938).
    """
    if nodes:
        nodes_x, nodes_y, nodes_z = nodes
    else:
        nodes_x = np.round(grid.nodes_x, decimals)
        nodes_y = np.round(grid.nodes_y, decimals)
        nodes_z = np.round(grid.nodes_z, decimals)
        pts = np.round(np.asarray(points, dtype=float), decimals)

        outside = (
            min(pts[:, 0]) < nodes_x[0] or max(pts[:, 0]) > nodes_x[-1] or
            min(pts[:, 1]) < nodes_y[0] or max(pts[:, 1]) > nodes_y[-1] or
            min(pts[:, 2]) < nodes_z[0] or max(pts[:, 2]) > nodes_z[-1])
        if outside:
            raise ValueError(f"Provided source outside grid: {pts}.")
        points = pts

    vfield = Field(grid, dtype=float)

    # Multi-segment wires: recurse per segment.
    if points.shape[0] != 2:
        for p0, p1 in zip(points[:-1, :], points[1:, :]):
            vfield.field = vfield.field + _dipole_vector(
                grid, points=np.r_[[p0, p1]], decimals=decimals,
                nodes=(nodes_x, nodes_y, nodes_z)).field
        return vfield

    dxdydz = points[1, :] - points[0, :]
    length = np.linalg.norm(dxdydz)
    if length < 1e-15:
        raise ValueError(f"Provided finite dipole has no length: {points}.")

    id_xyz = dxdydz.copy()
    id_xyz[id_xyz != 0] = 1 / id_xyz[id_xyz != 0]

    a1 = (nodes_x - points[0, 0]) * id_xyz[0]
    a2 = (nodes_y - points[0, 1]) * id_xyz[1]
    a3 = (nodes_z - points[0, 2]) * id_xyz[2]

    def min_max_ind(vector, i):
        vmin, vmax = min(points[:, i]), max(points[:, i])
        return [max(0, np.where(vmin < np.r_[vector, np.inf])[0][0] - 1),
                max(0, np.where(vmax < np.r_[vector, np.inf])[0][0] - 1)]

    rix = min_max_ind(nodes_x, 0)
    riy = min_max_ind(nodes_y, 1)
    riz = min_max_ind(nodes_z, 2)

    fx = np.zeros(grid.shape_edges_x)
    fy = np.zeros(grid.shape_edges_y)
    fz = np.zeros(grid.shape_edges_z)

    for iz in range(riz[0], min(riz[1] + 1, a3.size - 1)):
        for iy in range(riy[0], min(riy[1] + 1, a2.size - 1)):
            for ix in range(rix[0], min(rix[1] + 1, a1.size - 1)):
                aa = np.vstack([[a1[ix], a1[ix + 1]], [a2[iy], a2[iy + 1]],
                                [a3[iz], a3[iz + 1]]])
                aa = np.sort(aa[dxdydz != 0, :], 1)
                al = max(0, aa[:, 0].max())
                ar = min(1, aa[:, 1].min())

                xmin = points[0, :] + al * dxdydz
                xmax = points[0, :] + ar * dxdydz
                x_c = (xmin + xmax) / 2.0
                x_len = np.linalg.norm(xmax - xmin) / length

                rx = (x_c[0] - nodes_x[ix]) / grid.h[0][ix]
                ex = 1 - rx
                ry = (x_c[1] - nodes_y[iy]) / grid.h[1][iy]
                ey = 1 - ry
                rz = (x_c[2] - nodes_z[iz]) / grid.h[2][iz]
                ez = 1 - rz

                if min(rx, ex, ry, ey, rz, ez) >= 0 and \
                        np.max(abs(ar - al)) > 0:
                    fx[ix, iy, iz] += ey * ez * x_len
                    fx[ix, iy + 1, iz] += ry * ez * x_len
                    fx[ix, iy, iz + 1] += ey * rz * x_len
                    fx[ix, iy + 1, iz + 1] += ry * rz * x_len

                    fy[ix, iy, iz] += ex * ez * x_len
                    fy[ix + 1, iy, iz] += rx * ez * x_len
                    fy[ix, iy, iz + 1] += ex * rz * x_len
                    fy[ix + 1, iy, iz + 1] += rx * rz * x_len

                    fz[ix, iy, iz] += ex * ey * x_len
                    fz[ix + 1, iy, iz] += rx * ey * x_len
                    fz[ix, iy + 1, iz] += ex * ry * x_len
                    fz[ix + 1, iy + 1, iz] += rx * ry * x_len

    # Normalize if needed (should not happen); then scale by direction.
    for f in (fx, fy, fz):
        sum_s = abs(f.sum())
        if abs(sum_s - 1) > 1e-6:
            warnings.warn(f"emg3d_tpu_torch: Normalizing Source: {sum_s:.10f}.",
                          UserWarning)
            f /= sum_s

    vfield.fx = fx * dxdydz[0]
    vfield.fy = fy * dxdydz[1]
    vfield.fz = fz * dxdydz[2]

    return vfield
