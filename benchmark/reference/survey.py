"""The survey layer of emg3d, in plain NumPy (float64 and complex128).

What an inversion iterate computes around its solves, for an isotropic
resistivity model on an inversion mesh and electric point sources and
receivers, from plain arrays: the cell widths and origins of the two
grids, the resistivities, the positions, and the program's fields.

- :func:`volume_average`: a cell property of one grid onto another, as
  emg3d's ``Model.interpolate_to_grid`` moves a model onto the grid of
  a solve (method ``'volume'``; resistivities on a log10 scale);
- :func:`responses`: the fields at the receivers by linear
  interpolation on the edges of each component;
- :func:`weights` and :func:`misfit`: ``1 / std^2`` with
  ``std^2 = floor^2 + (relative error |observed|)^2``, and
  ``sum(w |synthetic - observed|^2) / 2``;
- :func:`adjoint_source`: the right-hand side of the back-propagation,
  the transpose of the receivers' interpolation applied to
  ``conj(w r / (-s mu_0))``, each receiver a point source of that
  strength (:func:`benchmark.reference.sources.point_field`);
- :func:`gradient`: ``Re(b s mu_0 e)`` on every edge, to cells (the
  cell volume times the mean of its four parallel edges), summed over
  the components, then the transpose of the volume averaging onto the
  inversion mesh, then the resistivity's chain rule ``-1 / rho^2``.

The volume averaging here is a product of three dense 1-D matrices of
overlaps: entry (o, i) is the length of output cell o that input cell i
covers, over the length of o, the input grid's outer cells reaching out
to cover the output grid (emg3d extrapolates a model by its outer
cells).  Departures from emg3d's description, and what it leaves open:

- isotropic models only (emg3d also takes VTI, HTI and triaxial ones),
  electric point receivers only, and no receiver in a grid's outermost
  cells (where emg3d returns NaN);
- emg3d averages a resistivity model in log10 while its gradient uses
  the transpose of the linear averaging.  The gradient is then the
  derivative of the misfit only where every cell of the computational
  grid lies within one cell of the inversion mesh (there both averages
  return the cell's own value); elsewhere it is emg3d's approximation,
  and this module computes the same.
"""

import numpy as np

from benchmark.reference import sources
from benchmark.reference.maxwell import smu0

__all__ = ["overlaps", "volume_average", "volume_average_adjoint",
           "responses", "weights", "misfit", "adjoint_source",
           "gradient"]


def overlaps(nodes_out, nodes_in):
    """(n_out, n_in): the share of each output cell that each input cell
    covers; the input grid's outer cells reach out to the output grid."""
    lo = np.asarray(nodes_in, dtype=float).copy()
    lo[0] = min(lo[0], nodes_out[0])
    lo[-1] = max(lo[-1], nodes_out[-1])
    out = np.asarray(nodes_out, dtype=float)
    length = (np.minimum(out[1:, None], lo[None, 1:])
              - np.maximum(out[:-1, None], lo[None, :-1]))
    return np.maximum(length, 0.0) / np.diff(out)[:, None]


def _apply(mats, values):
    """sum_abc M0[i, a] M1[j, b] M2[k, c] values[a, b, c]."""
    out = np.asarray(values, dtype=float)
    for axis, m in enumerate(mats):
        out = np.moveaxis(np.tensordot(m, out, axes=([1], [axis])), 0,
                          axis)
    return out


def volume_average(grid_in, values, grid_out, log=True):
    """A cell property of ``grid_in`` averaged over the cells of
    ``grid_out`` (two :class:`benchmark.reference.maxwell.Grid`)."""
    mats = [overlaps(o, i) for o, i in zip(grid_out.nodes, grid_in.nodes)]
    if log:
        return 10 ** _apply(mats, np.log10(values))
    return _apply(mats, values)


def volume_average_adjoint(grid_in, values_out, grid_out):
    """The transpose of the linear :func:`volume_average`: values on the
    cells of ``grid_out`` back onto those of ``grid_in``."""
    mats = [overlaps(o, i).T for o, i in zip(grid_out.nodes, grid_in.nodes)]
    return _apply(mats, values_out)


def responses(grid, field, receivers):
    """The field (three edge components) at each receiver row (x, y, z,
    azimuth, elevation), by linear interpolation."""
    out = np.zeros(len(receivers), dtype=complex)
    for n, row in enumerate(receivers):
        direction = sources.orientation(*row[3:5])
        for c in range(3):
            if abs(direction[c]) <= 1e-10:
                continue
            out[n] += direction[c] * sum(
                w * field[c][idx]
                for idx, w in sources._corners(grid, c, row[:3]))
    return out


def weights(observed, relative_error, noise_floor):
    """1 / std^2 of the data."""
    return 1.0 / (noise_floor ** 2
                  + (relative_error * np.abs(observed)) ** 2)


def misfit(synthetic, observed, weight):
    """sum(w |synthetic - observed|^2) / 2 over the finite data."""
    r = np.asarray(synthetic) - np.asarray(observed)
    return 0.5 * float(np.nansum(weight * np.abs(r) ** 2))


def adjoint_source(grid, receivers, residual, weight, frequency):
    """The adjoint source of one source's receivers: three complex edge
    arrays.  ``residual`` and ``weight`` hold one value per receiver; a
    receiver whose residual is NaN adds nothing."""
    out = tuple(np.zeros(s, dtype=complex) for s in grid.edge_shapes())
    strength = np.conj(residual * weight / -smu0(frequency))
    for row, s in zip(receivers, strength):
        if np.isnan(s):
            continue
        field = sources.point_field(grid, row[:3],
                                    sources.orientation(*row[3:5]), s,
                                    frequency)
        for a, b in zip(out, field):
            a += b
    return out


def gradient(grid, mesh, rho, efields, bfields, frequency):
    """The misfit's gradient with respect to the resistivities ``rho`` of
    ``mesh``, from the forward and back-propagated fields of every source
    on ``grid`` (lists of three edge components each)."""
    vol = grid.volumes()
    cells = np.zeros(grid.shape)
    for e, b in zip(efields, bfields):
        for c in range(3):
            g = np.real(np.asarray(b[c]) * smu0(frequency)
                        * np.asarray(e[c]))
            # The four edges of component c around each cell.
            a1, a2 = [a for a in range(3) if a != c]
            sl = [slice(None)] * 3

            def edges(i, j):
                sl[a1] = slice(i, i + grid.shape[a1])
                sl[a2] = slice(j, j + grid.shape[a2])
                return g[tuple(sl)]
            cells += vol * (edges(0, 0) + edges(1, 0) + edges(0, 1)
                            + edges(1, 1)) / 4
    return -volume_average_adjoint(mesh, cells, grid) / np.asarray(rho) ** 2
