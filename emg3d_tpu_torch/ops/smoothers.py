"""Gauss-Seidel smoothers (PyTorch): 8-color point and 4-color line.

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

Line relaxation (reference gauss_seidel_{x,y,z}, core.py:506-1616)
relaxes whole lines of edges along one axis: the lines are 4-colored by
the parity pair of their transverse node coordinates, and each line's
banded system is solved as a block-tridiagonal system of 5x5 blocks
(block-Thomas).  The y- and z-lines are the x-lines of a permuted frame
(the curl-curl operator is covariant under coordinate permutation).
:func:`gauss_seidel_line_phase` dispatches like the point phase: CPU
tensors run :func:`_line_relax_phase_torch`, CUDA tensors the
``line_phase`` kernel (:mod:`emg3d_tpu_torch.ops.line_phase`);
:func:`gauss_seidel_line` launches all phases of a smoothing call from
one validated plan.

Phases update the field tensors IN PLACE.

Every smoother takes fields with a leading task axis too (the batch
engine, :mod:`emg3d_tpu_torch.parallel.batch`): eta is then shared, with
an optional per-task ``scale`` (task k's eta is ``scale[k] * eta``), or
stacked ``(B, nx, ny, nz)``; zeta and the widths are shared.  The kernels
relax one color of every task per launch; the plain versions run task by
task (:func:`_per_task`), independently of the kernels.
"""

import itertools

import torch

from emg3d_tpu_torch.ops import gs_phase, line_phase

__all__ = ["gauss_seidel", "gauss_seidel_sweep", "gauss_seidel_phase",
           "gauss_seidel_line", "gauss_seidel_line_sweep",
           "gauss_seidel_line_phase", "phase_colors", "line_phase_colors",
           "solve_banded_5x5"]


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


def solve_banded_5x5(mat, rhs):
    """Solve batched 5x5 systems: mat (..., 5, 5), rhs (..., 5, m)."""
    rows = [mat[..., i, :] for i in range(5)]
    rr = [rhs[..., i, :] for i in range(5)]
    x = _solve_lower_unrolled(rows, rr)
    return torch.stack(x, dim=-2)


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
                 hx, hy, hz, nu, scale=None):
    """8-color node smoother: ``nu`` sweeps with alternating phase order.

    Updates ``ex``, ``ey``, ``ez`` in place and returns them.  CUDA
    tensors are validated once: one ``gs_phase.GsPlan`` launches all
    nu x 8 phases.
    """
    shape = (hx.numel(), hy.numel(), hz.numel())
    if ex.device.type != "cpu":
        plan = gs_phase.GsPlan(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                               zeta, hx, hy, hz, scale)
        for sweep in range(nu):
            for c in phase_colors(shape, sweep % 2 == 1):
                plan.launch(*c)
        return ex, ey, ez
    fields = (ex, ey, ez)
    for sweep in range(nu):
        fields = gauss_seidel_sweep(
            *fields, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
            hx, hy, hz, sweep % 2 == 1, scale)
    return fields


def gauss_seidel_sweep(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                       hx, hy, hz, reverse, scale=None):
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
            hx, hy, hz, *c, scale)
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
                       hx, hy, hz, px, py, pz, scale=None):
    """Relax the interior nodes of one (x, y, z)-parity class, in place.

    CPU tensors run the plain PyTorch version; CUDA tensors launch the
    ``gs_phase`` kernel (which raises on anything it does not take).
    Returns the updated (ex, ey, ez).
    """
    if ex.device.type == "cpu":
        return _gauss_seidel_phase_torch(
            ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
            hx, hy, hz, px, py, pz, scale)
    return gs_phase.gauss_seidel_phase_cuda(
        ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
        hx, hy, hz, px, py, pz, scale)


def _per_task(phase, ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
              hx, hy, hz, args, scale):
    """Run the plain ``phase`` task by task on fields with a leading
    task axis: task k with eta ``scale[k] * eta`` (shared), ``eta[k]``
    (stacked) or ``eta`` (shared, no scale).  The phase writes into the
    task's views, so the fields are updated in place."""
    eta = (eta_x, eta_y, eta_z)
    for k in range(ex.shape[0]):
        if eta_x.dim() == 4:
            eta_k = tuple(c[k] for c in eta)
        elif scale is not None:
            eta_k = tuple(scale[k] * c for c in eta)
        else:
            eta_k = eta
        phase(ex[k], ey[k], ez[k], sx[k], sy[k], sz[k], *eta_k, zeta,
              hx, hy, hz, *args)
    return ex, ey, ez


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
                              zeta, hx, hy, hz, px, py, pz, scale=None):
    """Plain PyTorch phase: assemble and solve the 6x6 node systems
    (reference core.py:392-492) for the stride-2 node subgrid with
    (ix-1, iy-1, iz-1) ≡ (px, py, pz) mod 2, on strided views of the
    inputs.  Writes the six solved edges of every phase node into
    ``ex``, ``ey``, ``ez`` IN PLACE and returns them.  Fields with a
    leading task axis run task by task (:func:`_per_task`).

    The reference the kernel is held against; it runs on any device.
    """
    if ex.dim() == 4:
        return _per_task(_gauss_seidel_phase_torch, ex, ey, ez, sx, sy, sz,
                         eta_x, eta_y, eta_z, zeta, hx, hy, hz,
                         (px, py, pz), scale)
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


# -------------------------------------------------------------------------
# 4-color line relaxation (reference gauss_seidel_{x,y,z} + blocks_to_amat
# + banded solve, core.py:506-1616), as batched block-tridiagonal (5x5
# blocks) solves.
# -------------------------------------------------------------------------

def gauss_seidel_line(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
                      hx, hy, hz, nu, axis, scale=None):
    """Line relaxation along ``axis``: nu sweeps, alternating order.

    Updates ``ex``, ``ey``, ``ez`` in place and returns them.  CUDA
    tensors are validated once: one ``line_phase.LinePlan`` launches all
    nu x 4 phases.
    """
    if ex.device.type != "cpu":
        plan = line_phase.LinePlan(ex, ey, ez, sx, sy, sz, eta_x, eta_y,
                                   eta_z, zeta, hx, hy, hz, axis, scale)
        shape = (hx.numel(), hy.numel(), hz.numel())
        for sweep in range(nu):
            for c in line_phase_colors(shape, axis, sweep % 2 == 1):
                plan.launch(*c)
        return ex, ey, ez
    fields = (ex, ey, ez)
    for sweep in range(nu):
        fields = gauss_seidel_line_sweep(
            *fields, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
            hx, hy, hz, sweep % 2 == 1, axis, scale)
    return fields


def gauss_seidel_line_sweep(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                            zeta, hx, hy, hz, reverse, axis, scale=None):
    """One 4-color line-relaxation sweep along ``axis`` (0, 1 or 2).

    ``reverse`` flips the color order.  Updates the fields in place and
    returns them.
    """
    shape = (hx.numel(), hy.numel(), hz.numel())
    fields = (ex, ey, ez)
    for c in line_phase_colors(shape, axis, reverse):
        fields = gauss_seidel_line_phase(
            *fields, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
            hx, hy, hz, *c, axis, scale)
    return fields


def line_phase_colors(shape_cells, axis, reverse):
    """The 4-color phase order for one line-relaxation sweep.

    The (p1, p2) parities refer to the transverse axes of the PERMUTED
    frame in which the x-line system is built (axis 0: (y, z); axis 1:
    (x, z); axis 2: (y, x)).  Parities without lines are skipped.
    """
    nx, ny, nz = shape_cells
    n1, n2 = {0: (ny, nz), 1: (nx, nz), 2: (ny, nx)}[axis]
    colors = [(p1, p2) for p2, p1 in itertools.product((0, 1), repeat=2)
              if p1 < n1 - 1 and p2 < n2 - 1]
    return colors[::-1] if reverse else colors


def gauss_seidel_line_phase(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                            zeta, hx, hy, hz, p1, p2, axis, scale=None):
    """Relax the lines along ``axis`` of transverse parity (p1, p2), in
    place (parities in the permuted frame, see :func:`line_phase_colors`).

    CPU tensors run the plain PyTorch version; CUDA tensors launch the
    ``line_phase`` kernel (which raises on anything it does not take).
    Returns the updated (ex, ey, ez).
    """
    if ex.device.type == "cpu":
        return _line_relax_phase_torch(
            ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
            hx, hy, hz, p1, p2, axis, scale)
    return line_phase.gauss_seidel_line_phase_cuda(
        ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,
        hx, hy, hz, p1, p2, axis, scale)


def _line_relax_phase_torch(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                            zeta, hx, hy, hz, p1, p2, axis, scale=None):
    """Plain PyTorch line phase along ``axis``, IN PLACE.

    The y- and z-lines are the x-lines of the frame permuted by
    ``line_phase.FRAMES[axis]``: the x-line phase runs on permuted VIEWS of
    the tensors, so its writes land in the original tensors.  Fields with
    a leading task axis run task by task (:func:`_per_task`).  The
    reference the ``line_phase`` kernel is held against; it runs on any
    device.  Returns (ex, ey, ez).
    """
    if axis not in line_phase.FRAMES:
        raise ValueError(f"axis must be 0, 1, or 2; got {axis}.")
    if ex.dim() == 4:
        return _per_task(_line_relax_phase_torch, ex, ey, ez, sx, sy, sz,
                         eta_x, eta_y, eta_z, zeta, hx, hy, hz,
                         (p1, p2, axis), scale)
    if ex.is_cuda:
        line_phase.PLAIN_CALLS_ON_CUDA += 1
    tp = line_phase.FRAMES[axis]
    e, s = (ex, ey, ez), (sx, sy, sz)
    eta, h = (eta_x, eta_y, eta_z), (hx, hy, hz)
    _line_relax_x_phase(*(e[r].permute(tp) for r in tp),
                        *(s[r].permute(tp) for r in tp),
                        *(eta[r].permute(tp) for r in tp),
                        zeta.permute(tp), *(h[r] for r in tp), p1, p2)
    return ex, ey, ez


def _line_x_system(gf, xc, py, pz, cdtype):
    """Assemble the block-tridiagonal x-line systems of one phase.

    ``gf(name, pat, ty, tz)`` gathers operand ``name`` (ex/ey/ez,
    sx/sy/sz, eta_x/eta_y/eta_z, zeta) as an (X, ncy, ncz) tensor: x
    pattern ``pat`` is ``'a'`` (x index = the group index g) or ``'b'``
    (x index = min(g+1, nx-1)); (ty, tz) are the start indices of the
    stride-2 transverse windows.  ``xc`` carries the broadcast width
    coefficients (kxa/kxb/ihxa/ihxb of shape (X, 1, 1) and the transverse
    kym/kyp/kzm/kzp/ihym/ihyp/ihzm/ihzp).

    Returns ``(mid, left, rhs)``: the 5x5 diagonal/sub-diagonal block
    stacks and the rhs, WITHOUT the last-group fix
    (:func:`_line_last_group_fix`).  Unknown order per group g: [ex(g),
    ey-, ey+, ez-, ez+] at node g+1 (reference core.py:680-766).
    """
    kxa, kxb = xc["kxa"], xc["kxb"]
    ihxa, ihxb = xc["ihxa"], xc["ihxb"]
    kym, kyp, kzm, kzp = xc["kym"], xc["kyp"], xc["kzm"], xc["kzp"]
    ihym, ihyp = xc["ihym"], xc["ihyp"]
    ihzm, ihzp = xc["ihzm"], xc["ihzp"]

    # Start indices of the phase windows: cell-type (m/p) and node-type
    # (ycN/ypN/ymN; the same starts serve the cell windows ymC/ypC).
    ym, yp, zm, zp = py, 1 + py, pz, 1 + pz
    ycN, ypN, ymN = 1 + py, 2 + py, py
    zcN, zpN, zmN = 1 + pz, 2 + pz, pz

    z = {}
    for xk in ("a", "b"):
        z[xk + "mm"] = gf("zeta", xk, ym, zm)
        z[xk + "mp"] = gf("zeta", xk, ym, zp)
        z[xk + "pm"] = gf("zeta", xk, yp, zm)
        z[xk + "pp"] = gf("zeta", xk, yp, zp)
    m = _m_coefficients(z, kxa, kxb, kym, kyp, kzm, kzp)

    st0 = (gf("eta_x", "a", ym, zm) + gf("eta_x", "a", yp, zm)
           + gf("eta_x", "a", ym, zp) + gf("eta_x", "a", yp, zp)) / 4.0
    st2 = (gf("eta_y", "b", ym, zm) + gf("eta_y", "b", ym, zp)
           + gf("eta_y", "a", ym, zm) + gf("eta_y", "a", ym, zp)) / 4.0
    st3 = (gf("eta_y", "b", yp, zm) + gf("eta_y", "b", yp, zp)
           + gf("eta_y", "a", yp, zm) + gf("eta_y", "a", yp, zp)) / 4.0
    st4 = (gf("eta_z", "b", yp, zm) + gf("eta_z", "b", ym, zm)
           + gf("eta_z", "a", yp, zm) + gf("eta_z", "a", ym, zm)) / 4.0
    st5 = (gf("eta_z", "b", yp, zp) + gf("eta_z", "b", ym, zp)
           + gf("eta_z", "a", yp, zp) + gf("eta_z", "a", ym, zp)) / 4.0

    blk = torch.broadcast_shapes(st0.shape, m["zyRxm"].shape)
    zero = torch.zeros(blk, dtype=cdtype, device=st0.device)

    def bc(v):
        return torch.broadcast_to(v, blk).to(cdtype)

    # Diagonal 5x5 block ``middle`` (core.py:680-711).
    m00 = bc(-st0 + m["zyRxm"] * ihyp + m["zyLxm"] * ihym
             + m["yzRxm"] * ihzp + m["yzLxm"] * ihzm)
    m11 = bc(-st2 + m["zxRym"] * ihxb + m["zxLym"] * ihxa
             + m["xzRym"] * ihzp + m["xzLym"] * ihzm)
    m22 = bc(-st3 + m["zxRyp"] * ihxb + m["zxLyp"] * ihxa
             + m["xzRyp"] * ihzp + m["xzLyp"] * ihzm)
    m33 = bc(-st4 + m["yxRzm"] * ihxb + m["yxLzm"] * ihxa
             + m["xyRzm"] * ihyp + m["xyLzm"] * ihym)
    m44 = bc(-st5 + m["yxRzp"] * ihxb + m["yxLzp"] * ihxa
             + m["xyRzp"] * ihyp + m["xyLzp"] * ihym)
    m10 = bc(-m["zyLxm"] * ihxa)
    m20 = bc(m["zyRxm"] * ihxa)
    m30 = bc(-m["yzLxm"] * ihxa)
    m40 = bc(m["yzRxm"] * ihxa)
    m31 = bc(-m["xzLym"] * ihym)
    m41 = bc(m["xzRym"] * ihym)
    m32 = bc(m["xzLyp"] * ihyp)
    m42 = bc(-m["xzRyp"] * ihyp)

    mid = torch.stack([
        torch.stack([m00, m10, m20, m30, m40], dim=-1),
        torch.stack([m10, m11, zero, m31, m41], dim=-1),
        torch.stack([m20, zero, m22, m32, m42], dim=-1),
        torch.stack([m30, m31, m32, m33, zero], dim=-1),
        torch.stack([m40, m41, m42, zero, m44], dim=-1),
    ], dim=-2)

    # Sub-diagonal block ``left`` (coupling to group g-1; core.py:713-721).
    l01 = bc(m["zyLxm"] * ihxa)
    l02 = bc(-m["zyRxm"] * ihxa)
    l03 = bc(m["yzLxm"] * ihxa)
    l04 = bc(-m["yzRxm"] * ihxa)
    l11 = bc(-m["zxLym"] * ihxa)
    l22 = bc(-m["zxLyp"] * ihxa)
    l33 = bc(-m["yxLzm"] * ihxa)
    l44 = bc(-m["yxLzp"] * ihxa)

    left = torch.stack([
        torch.stack([zero, l01, l02, l03, l04], dim=-1),
        torch.stack([zero, l11, zero, zero, zero], dim=-1),
        torch.stack([zero, zero, l22, zero, zero], dim=-1),
        torch.stack([zero, zero, zero, l33, zero], dim=-1),
        torch.stack([zero, zero, zero, zero, l44], dim=-1),
    ], dim=-2)

    # Off-line couplings moved to the rhs (core.py:723-766).
    r0 = (gf("sx", "a", ycN, zcN)
          + m["zyRxm"] * gf("ex", "a", ypN, zcN) * ihyp
          + m["zyLxm"] * gf("ex", "a", ymN, zcN) * ihym
          + m["yzRxm"] * gf("ex", "a", ycN, zpN) * ihzp
          + m["yzLxm"] * gf("ex", "a", ycN, zmN) * ihzm)

    r1 = (gf("sy", "b", ym, zcN)
          + (m["zxRym"] * gf("ex", "b", ymN, zcN)
             - m["zxLym"] * gf("ex", "a", ymN, zcN)
             + m["xzRym"] * gf("ez", "b", ymN, zp)
             - m["xzLym"] * gf("ez", "b", ymN, zm)) * ihym
          + m["xzRym"] * gf("ey", "b", ym, zpN) * ihzp
          + m["xzLym"] * gf("ey", "b", ym, zmN) * ihzm)

    r2 = (gf("sy", "b", yp, zcN)
          + (m["zxLyp"] * gf("ex", "a", ypN, zcN)
             - m["zxRyp"] * gf("ex", "b", ypN, zcN)
             + m["xzLyp"] * gf("ez", "b", ypN, zm)
             - m["xzRyp"] * gf("ez", "b", ypN, zp)) * ihyp
          + m["xzRyp"] * gf("ey", "b", yp, zpN) * ihzp
          + m["xzLyp"] * gf("ey", "b", yp, zmN) * ihzm)

    r3 = (gf("sz", "b", ycN, zm)
          + (m["yxRzm"] * gf("ex", "b", ycN, zmN)
             - m["yxLzm"] * gf("ex", "a", ycN, zmN)
             + m["xyRzm"] * gf("ey", "b", yp, zmN)
             - m["xyLzm"] * gf("ey", "b", ym, zmN)) * ihzm
          + m["xyRzm"] * gf("ez", "b", ypN, zm) * ihyp
          + m["xyLzm"] * gf("ez", "b", ymN, zm) * ihym)

    r4 = (gf("sz", "b", ycN, zp)
          + (m["yxLzp"] * gf("ex", "a", ycN, zpN)
             - m["yxRzp"] * gf("ex", "b", ycN, zpN)
             + m["xyLzp"] * gf("ey", "b", ym, zpN)
             - m["xyRzp"] * gf("ey", "b", yp, zpN)) * ihzp
          + m["xyRzp"] * gf("ez", "b", ypN, zp) * ihyp
          + m["xyLzp"] * gf("ez", "b", ymN, zp) * ihym)

    rhs = torch.stack([bc(r0), bc(r1), bc(r2), bc(r3), bc(r4)], dim=-1)
    return mid, left, rhs


def _line_last_group_fix(mid, left, rhs):
    """Apply the last-x-group reduction (reference core.py:1467-1477), in
    place on the stacks of :func:`_line_x_system`.

    The last group (g = nx-1) holds only the ex unknown: identity-pad
    the other four rows of its diagonal block, keep only row 0 of its
    ``left`` coupling, and zero the non-ex rhs entries.
    """
    eye_pad = torch.eye(5, dtype=mid.dtype, device=mid.device)
    eye_pad[0, 0] = 0.0
    e00 = torch.zeros((5, 5), dtype=mid.dtype, device=mid.device)
    e00[0, 0] = 1.0
    mid[-1] = e00 * mid[-1, ..., 0, 0][..., None, None] + eye_pad
    left[-1, :, :, 1:, :] = 0.0
    rhs[-1, :, :, 1:] = 0.0
    return mid, left, rhs


def _line_relax_x_phase(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z,
                        zeta, hx, hy, hz, py, pz):
    """Relax the x-lines at interior (y, z) nodes of parity (py, pz).

    Builds the block-tridiagonal line systems on strided windows of the
    inputs (:func:`_line_x_system`), solves all lines of the color with
    one batched block-Thomas elimination, and writes the on-line ex and
    the four transverse edges at node g+1 back IN PLACE.  Every operand
    is read before the first write; no line of the color writes an entry
    another line of the color reads.
    """
    nx, ny, nz = hx.numel(), hy.numel(), hz.numel()
    ncy, ncz = (ny - py) // 2, (nz - pz) // 2

    # x-gathers: a = g (the group index, 0..nx-1), b = min(g+1, nx-1).
    idx_b = torch.clamp(torch.arange(nx, device=hx.device) + 1, max=nx - 1)
    hx_b = hx[idx_b]

    def trow(v, t, nc):
        return v[t:t + 2 * nc:2]

    xc = {
        "kxa": (0.5 / hx)[:, None, None],
        "kxb": (0.5 / hx_b)[:, None, None],
        "ihxa": (1.0 / hx)[:, None, None],
        "ihxb": (1.0 / hx_b)[:, None, None],
        "kym": trow(0.5 / hy, py, ncy)[None, :, None],
        "kyp": trow(0.5 / hy, 1 + py, ncy)[None, :, None],
        "kzm": trow(0.5 / hz, pz, ncz)[None, None, :],
        "kzp": trow(0.5 / hz, 1 + pz, ncz)[None, None, :],
        "ihym": trow(1.0 / hy, py, ncy)[None, :, None],
        "ihyp": trow(1.0 / hy, 1 + py, ncy)[None, :, None],
        "ihzm": trow(1.0 / hz, pz, ncz)[None, None, :],
        "ihzp": trow(1.0 / hz, 1 + pz, ncz)[None, None, :],
    }

    fld = {"ex": ex, "ey": ey, "ez": ez, "sx": sx, "sy": sy, "sz": sz,
           "eta_x": eta_x, "eta_y": eta_y, "eta_z": eta_z, "zeta": zeta}

    def gf(name, pat, ty, tz):
        f = fld[name][:nx] if pat == "a" else fld[name][idx_b]
        return f[:, ty:ty + 2 * ncy:2, tz:tz + 2 * ncz:2]

    mid, left, rhs = _line_x_system(gf, xc, py, pz, ex.dtype)
    mid, left, rhs = _line_last_group_fix(mid, left, rhs)

    u = _block_thomas(mid, left, rhs)

    ycN = slice(1 + py, ny, 2)
    ymC = slice(py, ny - 1, 2)
    ypC = slice(1 + py, ny, 2)
    zcN = slice(1 + pz, nz, 2)
    zmC = slice(pz, nz - 1, 2)
    zpC = slice(1 + pz, nz, 2)
    ex[:, ycN, zcN] = u[..., 0]
    ey[1:nx, ymC, zcN] = u[:-1, ..., 1]
    ey[1:nx, ypC, zcN] = u[:-1, ..., 2]
    ez[1:nx, ycN, zmC] = u[:-1, ..., 3]
    ez[1:nx, ycN, zpC] = u[:-1, ..., 4]
    return ex, ey, ez


def _block_thomas(mid, left, rhs):
    """Solve batched block-tridiagonal systems (5x5 blocks) for all lines.

    Row g: ``left[g] u[g-1] + mid[g] u[g] + left[g+1]^T u[g+1] = rhs[g]``
    (the systems are complex-symmetric: transposed, never conjugated).
    Forward: C_g = M_g - L_g C_{g-1}^{-1} L_g^T; backward with the
    super-diagonal blocks L_{g+1}^T.  Batched over the line dimensions;
    the JAX package's two ``lax.scan``s are Python loops here.
    """
    n = mid.shape[0]
    cts, ys = [mid[0]], [rhs[0]]
    for g in range(1, n):
        # X = C_{g-1}^{-1} [L_g^T | y_{g-1}]
        rhs_cat = torch.cat([left[g].mT, ys[-1][..., None]], dim=-1)
        x = solve_banded_5x5(cts[-1], rhs_cat)
        cts.append(mid[g] - torch.einsum("...ij,...jk->...ik", left[g],
                                         x[..., :5]))
        ys.append(rhs[g] - torch.einsum("...ij,...j->...i", left[g],
                                        x[..., 5]))

    us = [solve_banded_5x5(cts[-1], ys[-1][..., None])[..., 0]]
    for g in range(n - 2, -1, -1):
        r = ys[g] - torch.einsum("...ji,...j->...i", left[g + 1], us[-1])
        us.append(solve_banded_5x5(cts[g], r[..., None])[..., 0])
    return torch.stack(us[::-1], dim=0)
