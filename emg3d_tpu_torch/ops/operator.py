"""Matrix-free curl-curl operator on the staggered Yee grid (PyTorch).

Port of ``emg3d_tpu.ops.operator`` (``amat_x``, ``residual``,
``residual_norm``, ``edge_curl_factor``): the reference's scalar triple
loop (``amat_x``, emg3d/core.py:57-206) as a vectorized 1-halo stencil over whole field
tensors: two nested discrete curls with dual-grid averaged material
parameters plus the sigma term.

Boundary handling matches the reference exactly: rows belonging to
tangential boundary edges get their curl part zeroed (PEC assumption,
core.py:193-198) while the sigma term is kept; edges on the far boundary
nodes (iy=ny / iz=nz planes etc.) are never touched.

Every function indexes the three grid axes from the end, so fields may
carry a leading task axis ``(B, ...)`` (the batch engine,
:mod:`emg3d_tpu_torch.parallel.batch`); eta is then either shared
``(nx, ny, nz)`` or stacked ``(B, nx, ny, nz)``, zeta and the widths are
shared.
"""

import torch

__all__ = ["amat_x", "residual", "residual_norm",
           "edge_curl_factor"]


def _first(p, axis):
    return p.narrow(axis, 0, 1)


def _pair_clamped(p, axis):
    """p[i-1] + p[i] along ``axis`` for i in [0..n], indices clamped to cells.

    Input has n entries along ``axis``; output has n+1 (node positions).
    """
    n = p.shape[axis]
    lo = torch.cat([_first(p, axis), p], dim=axis)
    hi = torch.cat([p, p.narrow(axis, n - 1, 1)], dim=axis)
    return lo + hi


def _shift_down_clamped(p, axis):
    """p[i-1] along ``axis`` with p[-1] := p[0] (clamped shift)."""
    return torch.cat([_first(p, axis), p.narrow(axis, 0, p.shape[axis] - 1)],
                     dim=axis)


def _sum_pairs_clamped(p, axis):
    """p[i] + p[i-1] along ``axis`` (clamped at 0); same length as input."""
    return p + _shift_down_clamped(p, axis)


def amat_x(ex, ey, ez, eta_x, eta_y, eta_z, zeta, hx, hy, hz):
    """Apply the system matrix: returns (A e)_x, (A e)_y, (A e)_z.

    Vectorized equivalent of the reference's ``amat_x``
    (emg3d/core.py:57-206) with the sign convention ``A e`` such that
    ``residual = sfield - A e`` and ``matvec = A e``.

    Parameters: field components (edge shapes), volume-scaled model
    parameters (cell shapes), and cell widths (1-D), all on one device.
    """
    nx, ny, nz = hx.numel(), hy.numel(), hz.numel()

    ihx = (1.0 / hx)[:, None, None]
    ihy = (1.0 / hy)[None, :, None]
    ihz = (1.0 / hz)[None, None, :]

    # --- First curl: V = curl E on the faces (Mulder06 Eq. 7). ------------
    v1 = ((ez[..., 1:, :] - ez[..., :-1, :]) * ihy
          - (ey[..., 1:] - ey[..., :-1]) * ihz)
    v2 = ((ex[..., 1:] - ex[..., :-1]) * ihz
          - (ez[..., 1:, :, :] - ez[..., :-1, :, :]) * ihx)
    v3 = ((ey[..., 1:, :, :] - ey[..., :-1, :, :]) * ihx
          - (ex[..., 1:, :] - ex[..., :-1, :]) * ihy)

    # --- Scale with dual-grid averaged zeta (factor 0.5 applied at the
    # end, like the reference).  Clamped averages at the boundaries. -------
    u1 = v1 * _pair_clamped(zeta, -3)
    u2 = v2 * _pair_clamped(zeta, -2)
    u3 = v3 * _pair_clamped(zeta, -1)

    # --- Second curl, on the cell-indexed edge block [0:nx, 0:ny, 0:nz]. --
    u1c = u1[..., :nx, :, :]
    u2c = u2[..., :ny, :]
    u3c = u3[..., :nz]

    u3_ihy = u3c * ihy
    u2_ihz = u2c * ihz
    u1_ihz = u1c * ihz
    u3_ihx = u3c * ihx
    u2_ihx = u2c * ihx
    u1_ihy = u1c * ihy

    rrx = (u3_ihy - _shift_down_clamped(u3_ihy, -2)
           - u2_ihz + _shift_down_clamped(u2_ihz, -1))
    rry = (u1_ihz - _shift_down_clamped(u1_ihz, -1)
           - u3_ihx + _shift_down_clamped(u3_ihx, -3))
    rrz = (u2_ihx - _shift_down_clamped(u2_ihx, -3)
           - u1_ihy + _shift_down_clamped(u1_ihy, -2))

    # Zero the curl part on tangential boundary edges (PEC rows,
    # reference core.py:193-198); the sigma term below is kept.  The
    # rr* tensors are fresh, so zeroing them in place is safe.
    rrx[..., 0, :] = 0
    rrx[..., 0] = 0
    rry[..., 0, :, :] = 0
    rry[..., 0] = 0
    rrz[..., 0, :, :] = 0
    rrz[..., 0, :] = 0

    # --- Sigma term: 4-cell averages of eta around each edge. -------------
    stx = _sum_pairs_clamped(_sum_pairs_clamped(eta_x, -2), -1)
    sty = _sum_pairs_clamped(_sum_pairs_clamped(eta_y, -3), -1)
    stz = _sum_pairs_clamped(_sum_pairs_clamped(eta_z, -3), -2)

    # Far-boundary edges (iy=ny, iz=nz planes etc.) stay zero (zero
    # operator rows), exactly like the reference's loop bounds.
    ax = torch.zeros_like(ex)
    ay = torch.zeros_like(ey)
    az = torch.zeros_like(ez)
    ax[..., :ny, :nz] = 0.5 * rrx - 0.25 * stx * ex[..., :ny, :nz]
    ay[..., :nx, :, :nz] = 0.5 * rry - 0.25 * sty * ey[..., :nx, :, :nz]
    az[..., :nx, :ny, :] = 0.5 * rrz - 0.25 * stz * ez[..., :nx, :ny, :]

    return ax, ay, az


def residual(sx, sy, sz, ex, ey, ez, eta_x, eta_y, eta_z, zeta, hx, hy, hz):
    """Residual r = s - A e (reference solver.py:1022-1070)."""
    ax, ay, az = amat_x(ex, ey, ez, eta_x, eta_y, eta_z, zeta, hx, hy, hz)
    return sx - ax, sy - ay, sz - az


def residual_norm(rx, ry, rz, per_task=False):
    """l2-norm over all three residual components (a 0-d tensor).

    ``per_task=True``: one norm per task of fields with a leading task
    axis, over the three grid axes (a ``(B,)`` tensor).
    """
    dims = (-3, -2, -1) if per_task else None
    return torch.sqrt(
        torch.sum(torch.abs(rx) ** 2, dim=dims)
        + torch.sum(torch.abs(ry) ** 2, dim=dims)
        + torch.sum(torch.abs(rz) ** 2, dim=dims))


def edge_curl_factor(ex, ey, ez, hx, hy, hz, zeta):
    """curl E on the faces, divided by dual-grid-averaged factor arrays.

    Used by ``get_magnetic_field``: H = curl E / (zeta * smu0), where the
    input ``zeta`` here is V/(mu_r*smu0) (reference fields.py:941-1009).
    Boundary faces (first/last face of each orientation) are zero.
    """
    ihx = (1.0 / hx)[:, None, None]
    ihy = (1.0 / hy)[None, :, None]
    ihz = (1.0 / hz)[None, None, :]

    fx = ((ez[:, 1:, :] - ez[:, :-1, :]) * ihy
          - (ey[:, :, 1:] - ey[:, :, :-1]) * ihz)
    fy = ((ex[:, :, 1:] - ex[:, :, :-1]) * ihz
          - (ez[1:, :, :] - ez[:-1, :, :]) * ihx)
    fz = ((ey[1:, :, :] - ey[:-1, :, :]) * ihx
          - (ex[:, 1:, :] - ex[:, :-1, :]) * ihy)

    # Dual-grid widths h[i-1] + h[i], clamped, at node positions.
    dx = _pair_clamped(hx, 0)[:, None, None]
    dy = _pair_clamped(hy, 0)[None, :, None]
    dz = _pair_clamped(hz, 0)[None, None, :]

    mx = fx * _pair_clamped(zeta, 0) / (
        dx * hy[None, :, None] * hz[None, None, :])
    my = fy * _pair_clamped(zeta, 1) / (
        hx[:, None, None] * dy * hz[None, None, :])
    mz = fz * _pair_clamped(zeta, 2) / (
        hx[:, None, None] * hy[None, :, None] * dz)

    # Reference leaves faces at index 0 (and the never-touched last face)
    # at zero (fields.py:1004-1009).
    mx[0, :, :] = mx[-1, :, :] = 0
    my[:, 0, :] = my[:, -1, :] = 0
    mz[:, :, 0] = mz[:, :, -1] = 0

    return mx, my, mz
