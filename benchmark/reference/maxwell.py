"""The discrete frequency-domain Maxwell system that emg3d solves.

On a tensor grid of cells ``h = (hx, hy, hz)`` the electric field lives
on the edges: ``ex`` of shape ``(nx, ny+1, nz+1)``, ``ey`` of
``(nx+1, ny, nz+1)``, ``ez`` of ``(nx+1, ny+1, nz)`` (C order, axes
x, y, z).  The system, scaled by the cell volumes as emg3d scales it
(Mulder, 2006, Geophysics 71(6), G285-G294), is

    A e = curl^T (zeta-weighted curl e) - (eta averaged to edges) e = s,

with ``eta = -s mu_0 V sigma`` (``s = 2 pi i f``) and ``zeta = V``
(``mu_r = 1``) per cell, and perfectly conducting outer walls: the rows
of edges that lie on a wall drop their curl part, and the edges of the
far walls (index ``n`` of a transverse axis) are outside the system.

Everything is plain PyTorch in complex128 on the device given.
"""

import math

import numpy as np
import torch
from scipy.constants import mu_0

__all__ = ["Grid", "eta_zeta", "apply_a", "rel_residual", "to_device"]

_C = torch.complex128
_R = torch.float64


class Grid:
    """A tensor grid: cell widths ``h`` (three 1-D arrays) and ``origin``.

    ``nodes[a]`` and ``centers[a]`` are the node and cell-centre
    coordinates along axis ``a``.
    """

    def __init__(self, h, origin):
        self.h = tuple(np.asarray(w, dtype=np.float64) for w in h)
        self.origin = tuple(float(o) for o in origin)
        self.nodes = tuple(o + np.concatenate([[0.0], np.cumsum(w)])
                           for o, w in zip(self.origin, self.h))
        self.centers = tuple(n[:-1] + w / 2
                             for n, w in zip(self.nodes, self.h))
        self.shape = tuple(len(w) for w in self.h)

    def volumes(self):
        hx, hy, hz = self.h
        return hx[:, None, None] * hy[None, :, None] * hz[None, None, :]

    def edge_shapes(self):
        nx, ny, nz = self.shape
        return ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                (nx + 1, ny + 1, nz))

    def edge_coordinates(self, component):
        """The (x, y, z) coordinate vectors of the edges of one field
        component: cell centres along the component, nodes across it."""
        return tuple(self.centers[a] if a == component else self.nodes[a]
                     for a in range(3))


def smu0(frequency):
    """s mu_0 of emg3d's convention, s = 2 pi i f (f > 0)."""
    return 2j * math.pi * frequency * mu_0


def eta_zeta(grid, rho, frequency, device):
    """(eta_x, eta_y, eta_z), zeta on ``device``: eta = -s mu_0 V / rho
    per cell for each of the three resistivities ``rho``, zeta = V."""
    vol = grid.volumes()
    eta = tuple(torch.as_tensor(-smu0(frequency) * vol / np.asarray(r),
                                dtype=_C, device=device) for r in rho)
    return eta, torch.as_tensor(vol, dtype=_R, device=device)


def to_device(arrays, device):
    """Three field components (any array type) as complex128 tensors."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=_C,
                                 device=device) for a in arrays)


def _prev(a, axis):
    """a[i-1] along ``axis``, with a[-1] taken as a[0]."""
    first = a.narrow(axis, 0, 1)
    return torch.cat([first, a.narrow(axis, 0, a.shape[axis] - 1)], axis)


def _node_sum(a, axis):
    """a[i-1] + a[i] at the n+1 nodes along ``axis`` of a cell array,
    the end cells counted twice at the walls."""
    padded = torch.cat([a.narrow(axis, 0, 1), a,
                        a.narrow(axis, a.shape[axis] - 1, 1)], axis)
    n = a.shape[axis] + 1
    return padded.narrow(axis, 0, n) + padded.narrow(axis, 1, n)


def _inv(w, axis):
    shape = [1, 1, 1]
    shape[axis] = -1
    return (1.0 / w).reshape(shape)


def apply_a(e, eta, zeta, h):
    """A e for the three edge components ``e``; ``h`` as three 1-D
    float64 tensors on the same device."""
    ex, ey, ez = e
    nx, ny, nz = (len(w) for w in h)
    ix, iy, iz = (_inv(w, a) for a, w in enumerate(h))

    # curl e on the faces (x-, y-, z-faces), weighted by zeta summed over
    # the two cells that share the face.
    fx = (torch.diff(ez, dim=1) * iy - torch.diff(ey, dim=2) * iz) \
        * _node_sum(zeta, 0)
    fy = (torch.diff(ex, dim=2) * iz - torch.diff(ez, dim=0) * ix) \
        * _node_sum(zeta, 1)
    fz = (torch.diff(ey, dim=0) * ix - torch.diff(ex, dim=1) * iy) \
        * _node_sum(zeta, 2)
    fx, fy, fz = fx[:nx], fy[:, :ny], fz[:, :, :nz]

    # The transposed curl onto the edges of the block [0:nx, 0:ny, 0:nz]:
    # the differences of the weighted face values around each edge.
    def back(f, inv, axis):
        g = f * inv
        return g - _prev(g, axis)

    cx = back(fz, iy, 1) - back(fy, iz, 2)
    cy = back(fx, iz, 2) - back(fz, ix, 0)
    cz = back(fy, ix, 0) - back(fx, iy, 1)
    # Walls: the edges on the first plane across each axis keep only
    # their eta term.
    cx[:, 0] = 0
    cx[:, :, 0] = 0
    cy[0] = 0
    cy[:, :, 0] = 0
    cz[0] = 0
    cz[:, 0] = 0

    def cells4(et, a1, a2):
        return et + _prev(et, a1) + _prev(et, a2) + _prev(_prev(et, a1), a2)

    out = tuple(torch.zeros_like(c) for c in e)
    out[0][:, :ny, :nz] = 0.5 * cx - 0.25 * cells4(eta[0], 1, 2) \
        * ex[:, :ny, :nz]
    out[1][:nx, :, :nz] = 0.5 * cy - 0.25 * cells4(eta[1], 0, 2) \
        * ey[:nx, :, :nz]
    out[2][:nx, :ny, :] = 0.5 * cz - 0.25 * cells4(eta[2], 0, 1) \
        * ez[:nx, :ny, :]
    return out


def rel_residual(s, e, eta, zeta, h):
    """||s - A e|| / ||s|| over all edges, as a float."""
    ae = apply_a(e, eta, zeta, h)
    num = sum(float(torch.sum(torch.abs(a - b) ** 2)) for a, b in zip(s, ae))
    den = sum(float(torch.sum(torch.abs(a) ** 2)) for a in s)
    return math.sqrt(num / den)
