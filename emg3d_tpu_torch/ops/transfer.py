"""Inter-grid transfer operators: restriction and prolongation (PyTorch).

Port of ``emg3d_tpu.ops.transfer``.  Both operators are *separable*: per
grid axis they are either

- identity                      (axis not coarsened),
- pairwise sum of the two children cells      (the component's own axis),
- a 3-point weighted nodal gather (wl, 1, wr)  (transverse axes), or
- for prolongation: 2-point linear nodal interpolation / cell duplication.

Chained 1-D gathers give all seven semicoarsening variants of the
reference (core.py:1620-2001; solver.py:947-1019) one code path.

The operator-dependent weights (Muld06 Eq. 9 with the [MoSu94] boundary
scheme; reference ``restrict_weights``, core.py:2004-2076) are tiny 1-D
host-side numpy computations, precomputed per multigrid level.
"""

import numpy as np
import torch

__all__ = ["restrict_weights", "restrict", "prolong_meta", "prolong",
           "restrict_model_parameters"]


def restrict_weights(nodes, cell_centers, h, cnodes, ccell_centers, ch):
    """1-D restriction weights (wl, w0, wr) for one coarsened axis.

    Host-side numpy; vectorized version of reference core.py:2004-2076.
    """
    n = len(cnodes)

    d = np.empty(n + 1)
    d[0] = h[0] / 2
    d[-1] = h[-1] / 2
    if n > 1:
        d[1:n] = (h[0:2 * n - 2:2] + h[1:2 * n - 1:2]) / 2

    wl = 1 / d[:-1]
    wl[0] *= (nodes[0] - h[0] / 2) - (cnodes[0] - ch[0] / 2)
    if n > 1:
        wl[1:] *= cell_centers[1:2 * n - 1:2] - ccell_centers[: n - 1]

    w0 = np.ones(n)

    wr = 1 / d[1:]
    wr[-1] *= (cnodes[-1] + ch[-1] / 2) - (nodes[-1] + h[-1] / 2)
    if n > 1:
        wr[:-1] *= ccell_centers[: n - 1] - cell_centers[0:2 * n - 2:2]

    return wl, w0, wr


def _bcast(w, axis):
    shape = [1, 1, 1]
    shape[axis] = w.shape[0]
    return w.reshape(shape)


def _nodal_gather(r, axis, wl, w0, wr):
    """Weighted 3-point nodal restriction along ``axis``.

    Coarse node L gathers fine nodes (2L-1, 2L, 2L+1), clamped at the
    boundaries, with weights (wl[L], w0[L], wr[L]) (1-D tensors on the
    device of ``r``).
    """
    n_f = r.shape[axis]
    n_c = wl.shape[0]
    idx0 = torch.arange(0, 2 * n_c, 2, device=r.device)
    idx_m = torch.clamp(idx0 - 1, min=0)
    idx_p = torch.clamp(idx0 + 1, max=n_f - 1)
    return (_bcast(wl, axis) * r.index_select(axis, idx_m)
            + _bcast(w0, axis) * r.index_select(axis, idx0)
            + _bcast(wr, axis) * r.index_select(axis, idx_p))


def _pair_sum(r, axis):
    """Sum of the two fine children cells along the component's own axis."""
    sl_even = [slice(None)] * 3
    sl_odd = [slice(None)] * 3
    sl_even[axis] = slice(0, None, 2)
    sl_odd[axis] = slice(1, None, 2)
    return r[tuple(sl_even)] + r[tuple(sl_odd)]


def restrict(rx, ry, rz, weights, coarsen):
    """Restrict the fine-grid residual to the coarse grid.

    Parameters
    ----------
    rx, ry, rz : torch.Tensor
        Fine-grid residual components (edge shapes).
    weights : ((wl, w0, wr), ...) per axis
        From :func:`restrict_weights`, as tensors on the fields' device;
        only used on coarsened axes (None otherwise).
    coarsen : (bool, bool, bool)
        Which axes are coarsened (all True for full coarsening; the
        semicoarsening variants of reference core.py:1671-2001 are the
        other combinations).
    """
    def comp(r, own):
        for axis in range(3):
            if not coarsen[axis]:
                continue
            if axis == own:
                r = _pair_sum(r, axis)
            else:
                r = _nodal_gather(r, axis, *weights[axis])
        return r

    return comp(rx, 0), comp(ry, 1), comp(rz, 2)


def restrict_model_parameters(param, coarsen):
    """Coarse model parameter: sum of the 2/4/8 children cells.

    Works on numpy arrays and tensors alike; mirrors reference
    solver.py:1667-1718.
    """
    for axis in range(3):
        if coarsen[axis]:
            param = _pair_sum(param, axis)
    return param


def prolong_meta(cnodes, fnodes):
    """1-D linear-interpolation metadata (idx, weight) coarse -> fine nodes.

    Equivalent to the weight computation of RegularGridProlongator
    (reference solver.py:1385-1478): fine node value =
    (1-w) * coarse[idx] + w * coarse[idx+1], with clamped extrapolation.
    Host-side numpy.
    """
    idx = np.clip(np.searchsorted(cnodes, fnodes) - 1, 0, cnodes.size - 2)
    w = (fnodes - cnodes[idx]) / (cnodes[idx + 1] - cnodes[idx])
    return idx.astype(np.int64), w


def _nodal_prolong(c, axis, idx, w):
    """Linear nodal interpolation along ``axis`` using precomputed meta."""
    w = _bcast(w, axis)
    lo = c.index_select(axis, idx)
    hi = c.index_select(axis, idx + 1)
    return (1.0 - w) * lo + w * hi


def prolong(ex, ey, ez, cex, cey, cez, pmeta, coarsen):
    """Add the prolonged coarse-grid correction to the fine field.

    Bilinear in the transverse directions, piecewise constant along the
    field direction; only interior (non-PEC) fine edges are updated
    (reference solver.py:947-1019).

    Updates ``ex``, ``ey`` and ``ez`` IN PLACE (an ``add_`` on their
    interior views) and returns them.  ``pmeta`` holds per-axis
    (idx, w) tensors from :func:`prolong_meta` for the coarsened axes
    (None otherwise).
    """
    def comp(e, c, own):
        for axis in range(3):
            if not coarsen[axis]:
                continue
            if axis == own:
                c = torch.repeat_interleave(c, 2, dim=axis)
            else:
                c = _nodal_prolong(c, axis, *pmeta[axis])

        # Interior-only add (PEC preserved).
        sl = [slice(None)] * 3
        for axis in range(3):
            if axis != own:
                sl[axis] = slice(1, -1)
        sl = tuple(sl)
        e[sl].add_(c[sl])
        return e

    return (comp(ex, cex, 0), comp(ey, cey, 1), comp(ez, cez, 2))
