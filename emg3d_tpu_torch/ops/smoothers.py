"""8-color point Gauss-Seidel smoother (PyTorch).

Port of the point smoother of ``emg3d_tpu.ops.smoothers``.  The
reference smoother (emg3d/core.py:210-503) is lexicographic Gauss-Seidel
over nodes: the 6 edges around a node are solved together as one
complex-symmetric 6x6 system.  Here the interior nodes are 8-colored by
their (x, y, z) parity: a node's system reads edges written only by nodes
in its 3x3x3 neighbourhood, and nodes of equal parity differ by even
offsets, so each color is an independent set and every phase is an exact
Gauss-Seidel update with the latest neighbour values.

:func:`gauss_seidel_phase` dispatches by the tensors' device: CPU tensors
run the plain PyTorch version (:func:`_gauss_seidel_phase_torch`), CUDA
tensors the hand-written kernel (:mod:`emg3d_tpu_torch.ops.gs_phase`).
Phases update the field tensors IN PLACE.
"""

import itertools

import torch

from emg3d_tpu_torch.ops import gs_phase

__all__ = ["gauss_seidel", "gauss_seidel_sweep", "gauss_seidel_phase",
           "phase_colors"]


# -------------------------------------------------------------------------
# Small dense solve, unrolled (no pivoting, no conjugation: the systems
# are complex-symmetric, like reference core.py:1481-1616).
# -------------------------------------------------------------------------

def _solve_lower_unrolled(mat_rows, rhs_rows):
    """Gaussian elimination without pivoting, fully unrolled.

    ``mat_rows``: list of n tensors (..., n) — the matrix rows;
    ``rhs_rows``: list of n tensors (..., m) — the rhs rows.
    Returns list of n tensors (..., m) — the solution rows.
    """
    n = len(mat_rows)
    rows = list(mat_rows)
    rhs = list(rhs_rows)

    for k in range(n):
        inv_piv = 1.0 / rows[k][..., k]
        for i in range(k + 1, n):
            f = rows[i][..., k] * inv_piv
            rows[i] = rows[i] - f[..., None] * rows[k]
            rhs[i] = rhs[i] - f[..., None] * rhs[k]

    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = rhs[i]
        for j in range(i + 1, n):
            acc = acc - rows[i][..., j, None] * x[j]
        x[i] = acc / rows[i][..., i, None]
    return x


def _solve6(rows, rhs):
    """Solve batched 6x6 systems given as 6 row-tensors and 6 rhs entries.

    rows[i]: (..., 6); rhs[i]: (...,).  Returns list of 6 (...) tensors.
    """
    rr = [r[..., None] for r in rhs]
    x = _solve_lower_unrolled(rows, rr)
    return [xi[..., 0] for xi in x]


# -------------------------------------------------------------------------
# Coefficient assembly.  Naming follows the reference (core.py:350-374):
# m{ab}{L|R}{x|y|z}{m|p} is the averaged 1/mu_r (zeta) coefficient of the
# curl-curl stencil; e.g. mzyRxm couples through the y-derivative at the
# right (R) y-side of the x-edge left (m) of the node.
# -------------------------------------------------------------------------

def _m_coefficients(z, kxa, kxb, kym, kyp, kzm, kzp):
    """The 24 averaged-zeta coefficients (reference core.py:350-374).

    ``z`` holds the eight zeta gathers keyed (x in {a,b}) (y in {m,p})
    (z in {m,p}); the k* are the half-inverse widths 0.5/h broadcast to
    the block shape.
    """
    m = {}
    m["zyLxm"] = kym * (z["amp"] + z["amm"])
    m["zyRxm"] = kyp * (z["app"] + z["apm"])
    m["yzLxm"] = kzm * (z["apm"] + z["amm"])
    m["yzRxm"] = kzp * (z["app"] + z["amp"])
    m["zyLxp"] = kym * (z["bmp"] + z["bmm"])
    m["zyRxp"] = kyp * (z["bpp"] + z["bpm"])
    m["yzLxp"] = kzm * (z["bpm"] + z["bmm"])
    m["yzRxp"] = kzp * (z["bpp"] + z["bmp"])
    m["zxLym"] = kxa * (z["amp"] + z["amm"])
    m["zxRym"] = kxb * (z["bmp"] + z["bmm"])
    m["xzLym"] = kzm * (z["bmm"] + z["amm"])
    m["xzRym"] = kzp * (z["bmp"] + z["amp"])
    m["zxLyp"] = kxa * (z["app"] + z["apm"])
    m["zxRyp"] = kxb * (z["bpp"] + z["bpm"])
    m["xzLyp"] = kzm * (z["bpm"] + z["apm"])
    m["xzRyp"] = kzp * (z["bpp"] + z["app"])
    m["yxLzm"] = kxa * (z["apm"] + z["amm"])
    m["yxRzm"] = kxb * (z["bpm"] + z["bmm"])
    m["xyLzm"] = kym * (z["bmm"] + z["amm"])
    m["xyRzm"] = kyp * (z["bpm"] + z["apm"])
    m["yxLzp"] = kxa * (z["app"] + z["amp"])
    m["yxRzp"] = kxb * (z["bpp"] + z["bmp"])
    m["xyLzp"] = kym * (z["bmp"] + z["amp"])
    m["xyRzp"] = kyp * (z["bpp"] + z["app"])
    return m


# -------------------------------------------------------------------------
# 8-color point smoother (reference gauss_seidel, core.py:210-503).
# -------------------------------------------------------------------------

def gauss_seidel(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                 hx, hy, hz, nu):
    """8-color node smoother: ``nu`` sweeps with alternating phase order.

    Updates ``ex``, ``ey``, ``ez`` in place and returns them.
    """
    fields = (ex, ey, ez)
    for sweep in range(nu):
        fields = gauss_seidel_sweep(
            *fields, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
            hx, hy, hz, sweep % 2 == 1)
    return fields


def gauss_seidel_sweep(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                       hx, hy, hz, reverse):
    """One 8-color sweep: per node, solve its 6-edge 6x6 subsystem.

    All interior nodes of one (x, y, z)-parity class are relaxed at once
    (their systems are decoupled); eight phases per sweep; ``reverse``
    flips the phase order (the analogue of the reference's alternating
    forward/backward ordering, core.py:308-311).  Updates the fields in
    place and returns them.
    """
    shape = (hx.numel(), hy.numel(), hz.numel())
    fields = (ex, ey, ez)
    for c in phase_colors(shape, reverse):
        fields = gauss_seidel_phase(
            *fields, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
            hx, hy, hz, *c)
    return fields


def phase_colors(shape_cells, reverse):
    """The 8-color phase order for one point-smoother sweep.

    Parities with no interior nodes (tiny grids) are skipped; ``reverse``
    flips the order (the analogue of the reference's backward sweep).
    """
    nx, ny, nz = shape_cells
    colors = [(px, py, pz) for pz, py, px in
              itertools.product((0, 1), repeat=3)
              if px < nx - 1 and py < ny - 1 and pz < nz - 1]
    return colors[::-1] if reverse else colors


def gauss_seidel_phase(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                       hx, hy, hz, px, py, pz):
    """Relax the interior nodes of one (x, y, z)-parity class, in place.

    CPU tensors run the plain PyTorch version; CUDA tensors launch the
    ``gs_phase`` kernel (which raises on anything it does not take).
    Returns the updated (ex, ey, ez).
    """
    if ex.device.type == "cpu":
        return _gauss_seidel_phase_torch(
            ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
            hx, hy, hz, px, py, pz)
    return gs_phase.gauss_seidel_phase_cuda(
        ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
        hx, hy, hz, px, py, pz)


def _csl(o, n, p):
    """Cell-type slice at the phase nodes: o in {0, 1} (cells ix-1, ix)."""
    return slice(o + p, n - 1 + o, 2)


def _nsl(d, n, p):
    """Node-type slice: d in {-1, 0, 1} (nodes ix-1, ix, ix+1)."""
    return slice(1 + d + p, n + d, 2)


def _phase_solve(gf, st, m, ih):
    """Assemble and solve the per-node 6x6 systems of one point phase.

    ``gf(name, i, j, k)`` gathers field/source component ``name`` on
    the phase block; each index is interpreted per the component's
    axis kinds (ex/sx: cell-node-node; ey/sy: node-cell-node; ez/sz:
    node-node-cell), cell offsets i in {0, 1}, node offsets in
    {-1, 0, 1}.  ``st`` are the six diagonal eta sums (already /4),
    ``m`` the 24 averaged-zeta coefficients (:func:`_m_coefficients`),
    ``ih`` the broadcast inverse widths {ihxa, ihxb, ihym, ihyp, ihzm,
    ihzp}.  Returns the six solution blocks [ex-, ex+, ey-, ey+, ez-,
    ez+] (reference core.py:392-492).
    """
    st0, st1, st2, st3, st4, st5 = st
    ihxa, ihxb = ih["ihxa"], ih["ihxb"]
    ihym, ihyp = ih["ihym"], ih["ihyp"]
    ihzm, ihzp = ih["ihzm"], ih["ihzp"]

    shape = torch.broadcast_shapes(st0.shape, m["zyRxm"].shape)
    zero = torch.zeros(shape, dtype=st0.dtype, device=st0.device)

    a00 = (-st0 + m["zyRxm"] * ihyp + m["zyLxm"] * ihym
           + m["yzRxm"] * ihzp + m["yzLxm"] * ihzm)
    a11 = (-st1 + m["zyRxp"] * ihyp + m["zyLxp"] * ihym
           + m["yzRxp"] * ihzp + m["yzLxp"] * ihzm)
    a22 = (-st2 + m["zxRym"] * ihxb + m["zxLym"] * ihxa
           + m["xzRym"] * ihzp + m["xzLym"] * ihzm)
    a33 = (-st3 + m["zxRyp"] * ihxb + m["zxLyp"] * ihxa
           + m["xzRyp"] * ihzp + m["xzLyp"] * ihzm)
    a44 = (-st4 + m["yxRzm"] * ihxb + m["yxLzm"] * ihxa
           + m["xyRzm"] * ihyp + m["xyLzm"] * ihym)
    a55 = (-st5 + m["yxRzp"] * ihxb + m["yxLzp"] * ihxa
           + m["xyRzp"] * ihyp + m["xyLzp"] * ihym)

    a20 = -m["zyLxm"] * ihxa + zero
    a30 = m["zyRxm"] * ihxa + zero
    a40 = -m["yzLxm"] * ihxa + zero
    a50 = m["yzRxm"] * ihxa + zero
    a21 = m["zyLxp"] * ihxb + zero
    a31 = -m["zyRxp"] * ihxb + zero
    a41 = m["yzLxp"] * ihxb + zero
    a51 = -m["yzRxp"] * ihxb + zero
    a42 = -m["xzLym"] * ihym + zero
    a52 = m["xzRym"] * ihym + zero
    a43 = m["xzLyp"] * ihyp + zero
    a53 = -m["xzRyp"] * ihyp + zero
    a10 = a32 = a54 = zero

    rows = [
        torch.stack([a00, a10, a20, a30, a40, a50], dim=-1),
        torch.stack([a10, a11, a21, a31, a41, a51], dim=-1),
        torch.stack([a20, a21, a22, a32, a42, a52], dim=-1),
        torch.stack([a30, a31, a32, a33, a43, a53], dim=-1),
        torch.stack([a40, a41, a42, a43, a44, a54], dim=-1),
        torch.stack([a50, a51, a52, a53, a54, a55], dim=-1),
    ]

    # rhs = b - (couplings to all 12 non-node edges); core.py:432-492.
    r0 = (gf("sx", 0, 0, 0)
          + m["zyRxm"] * (gf("ey", -1, 1, 0) * ihxa
                          + gf("ex", 0, 1, 0) * ihyp)
          + m["zyLxm"] * (-gf("ey", -1, 0, 0) * ihxa
                          + gf("ex", 0, -1, 0) * ihym)
          + m["yzRxm"] * (gf("ez", -1, 0, 1) * ihxa
                          + gf("ex", 0, 0, 1) * ihzp)
          + m["yzLxm"] * (-gf("ez", -1, 0, 0) * ihxa
                          + gf("ex", 0, 0, -1) * ihzm))

    r1 = (gf("sx", 1, 0, 0)
          + m["zyRxp"] * (-gf("ey", 1, 1, 0) * ihxb
                          + gf("ex", 1, 1, 0) * ihyp)
          + m["zyLxp"] * (gf("ey", 1, 0, 0) * ihxb
                          + gf("ex", 1, -1, 0) * ihym)
          + m["yzRxp"] * (-gf("ez", 1, 0, 1) * ihxb
                          + gf("ex", 1, 0, 1) * ihzp)
          + m["yzLxp"] * (gf("ez", 1, 0, 0) * ihxb
                          + gf("ex", 1, 0, -1) * ihzm))

    r2 = (gf("sy", 0, 0, 0)
          + m["zxRym"] * (gf("ey", 1, 0, 0) * ihxb
                          + gf("ex", 1, -1, 0) * ihym)
          + m["zxLym"] * (gf("ey", -1, 0, 0) * ihxa
                          - gf("ex", 0, -1, 0) * ihym)
          + m["xzRym"] * (gf("ez", 0, -1, 1) * ihym
                          + gf("ey", 0, 0, 1) * ihzp)
          + m["xzLym"] * (-gf("ez", 0, -1, 0) * ihym
                          + gf("ey", 0, 0, -1) * ihzm))

    r3 = (gf("sy", 0, 1, 0)
          + m["zxRyp"] * (gf("ey", 1, 1, 0) * ihxb
                          - gf("ex", 1, 1, 0) * ihyp)
          + m["zxLyp"] * (gf("ey", -1, 1, 0) * ihxa
                          + gf("ex", 0, 1, 0) * ihyp)
          + m["xzRyp"] * (-gf("ez", 0, 1, 1) * ihyp
                          + gf("ey", 0, 1, 1) * ihzp)
          + m["xzLyp"] * (gf("ez", 0, 1, 0) * ihyp
                          + gf("ey", 0, 1, -1) * ihzm))

    r4 = (gf("sz", 0, 0, 0)
          + m["yxRzm"] * (gf("ez", 1, 0, 0) * ihxb
                          + gf("ex", 1, 0, -1) * ihzm)
          + m["yxLzm"] * (gf("ez", -1, 0, 0) * ihxa
                          - gf("ex", 0, 0, -1) * ihzm)
          + m["xyRzm"] * (gf("ez", 0, 1, 0) * ihyp
                          + gf("ey", 0, 1, -1) * ihzm)
          + m["xyLzm"] * (gf("ez", 0, -1, 0) * ihym
                          - gf("ey", 0, 0, -1) * ihzm))

    r5 = (gf("sz", 0, 0, 1)
          + m["yxRzp"] * (gf("ez", 1, 0, 1) * ihxb
                          - gf("ex", 1, 0, 1) * ihzp)
          + m["yxLzp"] * (gf("ez", -1, 0, 1) * ihxa
                          + gf("ex", 0, 0, 1) * ihzp)
          + m["xyRzp"] * (gf("ez", 0, 1, 1) * ihyp
                          - gf("ey", 0, 1, 1) * ihzp)
          + m["xyLzp"] * (gf("ez", 0, -1, 1) * ihym
                          + gf("ey", 0, 0, 1) * ihzp))

    return _solve6(rows, [r0, r1, r2, r3, r4, r5])


def _gauss_seidel_phase_torch(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                              zeta, hx, hy, hz, px, py, pz):
    """Plain PyTorch phase: assemble and solve the 6x6 node systems
    (reference core.py:392-492) for the stride-2 node subgrid with
    (ix-1, iy-1, iz-1) ≡ (px, py, pz) mod 2, on strided views of the
    inputs.  Writes the six solved edges of every phase node into
    ``ex``, ``ey``, ``ez`` IN PLACE and returns them.

    The reference the kernel is held against; it runs on any device.
    """
    if ex.is_cuda:
        gs_phase.PLAIN_CALLS_ON_CUDA += 1
    nx, ny, nz = hx.numel(), hy.numel(), hz.numel()

    kx, ky, kz = 0.5 / hx, 0.5 / hy, 0.5 / hz
    ihx, ihy, ihz = 1.0 / hx, 1.0 / hy, 1.0 / hz

    xa, xb = _csl(0, nx, px), _csl(1, nx, px)
    ym, yp = _csl(0, ny, py), _csl(1, ny, py)
    zm, zp = _csl(0, nz, pz), _csl(1, nz, pz)

    kxa = kx[xa][:, None, None]
    kxb = kx[xb][:, None, None]
    kym = ky[ym][None, :, None]
    kyp = ky[yp][None, :, None]
    kzm = kz[zm][None, None, :]
    kzp = kz[zp][None, None, :]
    ih = {
        "ihxa": ihx[xa][:, None, None], "ihxb": ihx[xb][:, None, None],
        "ihym": ihy[ym][None, :, None], "ihyp": ihy[yp][None, :, None],
        "ihzm": ihz[zm][None, None, :], "ihzp": ihz[zp][None, None, :],
    }

    z = {}
    for xk, xs in (("a", xa), ("b", xb)):
        z[xk + "mm"] = zeta[xs, ym, zm]
        z[xk + "mp"] = zeta[xs, ym, zp]
        z[xk + "pm"] = zeta[xs, yp, zm]
        z[xk + "pp"] = zeta[xs, yp, zp]
    m = _m_coefficients(z, kxa, kxb, kym, kyp, kzm, kzp)

    n_ = (nx, ny, nz)
    p_ = (px, py, pz)

    def st(eta, sl, ax):
        # 4-cell sum over the two axes != ax, at phase offsets, / 4
        # (reference core.py:390).
        others = [i for i in range(3) if i != ax]
        out = 0.0
        for d1 in (0, 1):
            for d2 in (0, 1):
                idx = [None, None, None]
                idx[ax] = sl
                idx[others[0]] = _csl(d1, n_[others[0]], p_[others[0]])
                idx[others[1]] = _csl(d2, n_[others[1]], p_[others[1]])
                out = out + eta[tuple(idx)]
        return out / 4.0

    sts = (st(eta_x, xa, 0), st(eta_x, xb, 0), st(eta_y, ym, 1),
           st(eta_y, yp, 1), st(eta_z, zm, 2), st(eta_z, zp, 2))

    fld = {"ex": ex, "ey": ey, "ez": ez, "sx": sx, "sy": sy, "sz": sz}
    kinds = {"ex": "cnn", "sx": "cnn", "ey": "ncn", "sy": "ncn",
             "ez": "nnc", "sz": "nnc"}

    def gf(name, i, j, k):
        sls = tuple(_csl(v, n, p) if knd == "c" else _nsl(v, n, p)
                    for v, knd, n, p in zip((i, j, k), kinds[name], n_, p_))
        return fld[name][sls]

    sol = _phase_solve(gf, sts, m, ih)

    # Scatter the solutions to the six edges of the phase's nodes:
    # disjoint strided targets, none of which the phase read.
    ex[_csl(0, nx, px), _nsl(0, ny, py), _nsl(0, nz, pz)] = sol[0]
    ex[_csl(1, nx, px), _nsl(0, ny, py), _nsl(0, nz, pz)] = sol[1]
    ey[_nsl(0, nx, px), _csl(0, ny, py), _nsl(0, nz, pz)] = sol[2]
    ey[_nsl(0, nx, px), _csl(1, ny, py), _nsl(0, nz, pz)] = sol[3]
    ez[_nsl(0, nx, px), _nsl(0, ny, py), _csl(0, nz, pz)] = sol[4]
    ez[_nsl(0, nx, px), _nsl(0, ny, py), _csl(1, nz, pz)] = sol[5]
    return ex, ey, ez
