"""Native 1-D layered-earth CSEM engine (frequency domain).

Copy of ``emg3d_tpu.layered`` for the PyTorch port (numpy and scipy
only; the text below speaks of the JAX package it was written for).
The reference delegates all layered (1-D) modelling to empymod
(emg3d/_multiprocessing.py:156-463); emg3d_tpu bundles a self-contained
engine instead, built on the transmission-line formalism for layered
media (Michalski & Zheng 1990; Løseth & Ursin 2007 for the VTI
generalization) and the native Hankel-DLF filters
(:func:`emg3d_tpu.transforms.design_hankel_filter`):

- Each mode (TE/TM) in each layer is a 1-D transmission line with
  vertical wavenumber Γ and characteristic impedance Z:

      TE:  Γ² = λ² + ζ η_h            Z = ζ / Γ
      TM:  Γ² = (η_h/η_v) λ² + ζ η_h  Z = Γ / η_h

  with η = σ (+ iωε₀) per layer, ζ = iωμ₀, s = iω (the solver's
  convention, fields.py ``sval``).
- A horizontal electric dipole excites both modes as a *shunt current*
  TL source; a vertical electric dipole excites TM only as a *series
  voltage* source of spectral amplitude λ/(2π η_v(zs)) (derived from
  Maxwell's equations in the Hankel domain; validated against the
  analytic fullspace solution).
- In the source layer the up/down wave amplitudes follow from the two
  boundary reflection conditions,
      A = R_a (u + R_b E d)/D,   B = R_b (d + R_a E u)/D,
      E = e^{-Γ d},  D = 1 − R_a R_b E²,
  with (u, d) the up/down-going direct-wave values at the layer
  boundaries (signed per source type).  Receivers in other layers are
  reached by the interface-continuity walk
      V(z_k) = V(z_{k-1}) e^{-Γ_k d_k} (1 + R̃_k)/(1 + R̃_k e^{-2Γ_k d_k}),
  which transmits the total voltage across each passive layer.
- The wavenumber → space transform is a J0/J1 digital linear filter.

For receivers in the source layer the direct (primary) term is excluded
from the wavenumber kernels (it decays only algebraically in λ when
zr ≈ zs) and the closed-form VTI wholespace field
(:func:`_vti_fullspace_primary`) is added in the space domain instead —
so every layer, including the source layer with same-layer receivers,
may be VTI.

Validation: a uniform "layered" model reproduces the analytical
fullspace dipole solution for arbitrary source orientation and
receivers in any layer (transmission bookkeeping); electromagnetic
reciprocity (VED↔HED) holds across layers; layered cases are
cross-checked against the 3-D multigrid solver in tests/test_layered.py.
"""

import numpy as np
from scipy import constants as const

from emg3d_tpu_torch import transforms

__all__ = ['dipole_layered', 'fields_layered']


def __dir__():
    return __all__


def _fullspace_primary(rvec, p, eta, zeta):
    """Analytic fullspace E and H of a unit electric point dipole.

    Isotropic medium: E from the Hertz-potential closed form (the same
    expression as tests/alternatives.fullspace_dipole), H from
    ∇×(p f) = ∇f × p with f = e^{-γr}/(4πr).
    """
    r = np.linalg.norm(rvec, axis=1)
    rh = rvec / r[:, None]
    gam = np.sqrt(zeta * eta)

    gr = gam * r
    f = np.exp(-gr) / (4 * np.pi * eta * r ** 3)
    t1 = (gr ** 2 + 3 * gr + 3)[:, None] * (rh @ p)[:, None] * rh
    t2 = (gr ** 2 + gr + 1)[:, None] * p[None, :]
    e = f[:, None] * (t1 - t2)

    hmag = (gr + 1) * np.exp(-gr) / (4 * np.pi * r ** 2)
    h = hmag[:, None] * np.cross(np.broadcast_to(p, rvec.shape), rh)
    return e, h


def _sommerfeld_table(gam, rho, h):
    """Closed forms of the Sommerfeld-family Hankel integrals.

    All with kernel e^{-Γh}, Γ = sqrt(λ² + γ²), h = |Δz| ≥ 0,
    R = sqrt(ρ² + h²):

        I1 = ∫ (λ/Γ)  e^{-Γh} J0 dλ = e^{-γR}/R          (Sommerfeld)
        I2 = ∫  λ     e^{-Γh} J0 dλ = -∂h I1
        I3 = ∫  λΓ    e^{-Γh} J0 dλ = ∂²h I1
        I4 = ∫ (1/Γ)  e^{-Γh} J1 dλ = (e^{-γh} − e^{-γR})/(γρ)
        I5 = ∫  1     e^{-Γh} J1 dλ = -∂h I4
        I6 = ∫  Γ     e^{-Γh} J1 dλ = ∂²h I4
        I7 = ∫ (λ²/Γ) e^{-Γh} J1 dλ = -∂ρ I1
        I8 = ∫  λ²    e^{-Γh} J1 dλ = -∂h I7
        I9 = ∫ (λ³/Γ) e^{-Γh} J0 dλ = I3 − γ² I1   (λ² = Γ² − γ²)

    Each identity is validated numerically against the DLF in
    tests/test_layered.py.
    """
    r2 = rho ** 2 + h ** 2
    r = np.sqrt(r2)
    gr = gam * r
    egr = np.exp(-gr)
    egh = np.exp(-gam * h)

    i1 = egr / r
    i2 = h * (gr + 1) * egr / r ** 3
    i3 = egr * (h ** 2 * (gr ** 2 + 3 * gr + 3) / r ** 5 - (gr + 1) / r ** 3)
    i4 = (egh - egr) / (gam * rho)
    i5 = (egh - (h / r) * egr) / rho
    i6 = (gam ** 2 * egh
          - (gam ** 2 * h ** 2 / r2 - gam * rho ** 2 / r ** 3) * egr
          ) / (gam * rho)
    i7 = rho * (gr + 1) * egr / r ** 3
    i8 = rho * h * (gr ** 2 + 3 * gr + 3) * egr / r ** 5
    i9 = i3 - gam ** 2 * i1
    return {'i1': i1, 'i2': i2, 'i3': i3, 'i4': i4, 'i5': i5,
            'i6': i6, 'i7': i7, 'i8': i8, 'i9': i9}


def _vti_fullspace_kernels(rho, dz, eta_h, eta_v, zeta):
    """Closed-form spectral-kernel values of a dipole in a VTI wholespace.

    Returns the same kernel set the DLF path of :func:`fields_layered`
    computes (sum_v, dif_v, sum_i, dif_i, ez_ker, hz_ker and the VED
    kernels), but evaluated analytically: the TE-mode integrals are the
    isotropic Sommerfeld forms; the TM mode has Γm² = Λ²λ² + γ² with
    Λ² = η_h/η_v, and the substitution u = Λλ turns every TM integral
    into an isotropic one at the scaled horizontal distance ρ/Λ with a
    power of 1/Λ: ∫ λ^a Γm^b e^{-Γm h} Jn(λρ) dλ
    = Λ^{-(a+1)} ∫ u^a Γ^b e^{-Γh} Jn(uρ/Λ) du.

    ``dz`` = zr − zs in the internal z-down frame (its sign enters the
    odd TL current kernels).
    """
    h = np.abs(dz)
    sgn = np.sign(dz)
    gam = np.sqrt(zeta * eta_h)
    lam_a = np.sqrt(eta_h / eta_v)          # anisotropy Λ
    rho_m = rho / lam_a

    te = _sommerfeld_table(gam, rho, h)
    tm = _sommerfeld_table(gam, rho_m, h)

    il = 1.0 / lam_a
    # V_te = (ζ/2Γe) e^{-Γe h};  V_tm = (Γm/2η_h) e^{-Γm h};
    # I_mode = (sgn/2) e^{-Γ h}.
    h0_lv_te = 0.5 * zeta * te['i1']
    h0_lv_tm = 0.5 / eta_h * il ** 2 * tm['i3']
    h1_v_te = 0.5 * zeta * te['i4']
    h1_v_tm = 0.5 / eta_h * il * tm['i6']
    h0_li_te = 0.5 * sgn * te['i2']
    h0_li_tm = 0.5 * sgn * il ** 2 * tm['i2']
    h1_i_te = 0.5 * sgn * te['i5']
    h1_i_tm = 0.5 * sgn * il * tm['i5']

    sum_v = h0_lv_te + h0_lv_tm
    dif_v = (2.0 / rho) * (h1_v_te - h1_v_tm) - (h0_lv_te - h0_lv_tm)
    sum_i = h0_li_te + h0_li_tm
    dif_i = (2.0 / rho) * (h1_i_te - h1_i_tm) - (h0_li_te - h0_li_tm)
    ez_ker = sgn / eta_v * il ** 3 * tm['i8']
    hz_ker = te['i7']

    # VED (TM only): V_v = (sgn/2) e^{-Γm h}; I_v = (η_h/2Γm) e^{-Γm h}.
    ved_e_rho = 0.5 * sgn * il ** 3 * tm['i8']
    ved_e_z = 0.5 * eta_h * il ** 4 * tm['i9']
    ved_h_phi = 0.5 * eta_h * il ** 3 * tm['i7']

    return {'sum_v': sum_v, 'dif_v': dif_v, 'sum_i': sum_i,
            'dif_i': dif_i, 'ez_ker': ez_ker, 'hz_ker': hz_ker,
            'ved_e_rho': ved_e_rho, 'ved_e_z': ved_e_z,
            'ved_h_phi': ved_h_phi}


def _vti_fullspace_primary(rvec, p, eta_h, eta_v, zeta):
    """E and H of a unit electric dipole in a VTI wholespace (closed form).

    ``rvec``: (n, 3) receiver − source in the GLOBAL z-up frame;
    ``p``: dipole moment (z-up).  Assembles the analytic kernel values
    of :func:`_vti_fullspace_kernels` exactly like the DLF path of
    :func:`fields_layered` (same internal z-down frame, same polar/axial
    output mapping).  Reduces to :func:`_fullspace_primary` for
    η_v = η_h.
    """
    rvec = np.atleast_2d(rvec)
    dx, dy = rvec[:, 0], rvec[:, 1]
    dz = -rvec[:, 2]                       # z-down internal frame
    rho = np.maximum(np.hypot(dx, dy), 1e-9)
    cphi, sphi = dx / rho, dy / rho

    ker = _vti_fullspace_kernels(rho, dz, eta_h, eta_v, zeta)

    n = rvec.shape[0]
    out_e = np.zeros((n, 3), dtype=np.complex128)
    out_h = np.zeros((n, 3), dtype=np.complex128)

    p_h = np.asarray(p[:2], dtype=np.float64)
    mh = np.hypot(p_h[0], p_h[1])
    pz_down = -p[2]

    if mh > 0:
        ca, sa = p_h[0] / mh, p_h[1] / mh
        cb = cphi * ca + sphi * sa
        sb = -cphi * sa + sphi * ca
        c2b = cb * cb - sb * sb
        s2b = 2 * sb * cb

        exp_ = -(ker['sum_v'] + c2b * ker['dif_v']) / (4 * np.pi)
        eyp_ = -(s2b * ker['dif_v']) / (4 * np.pi)
        ezp_ = cb * ker['ez_ker'] / (4 * np.pi)
        hxp_ = (s2b * ker['dif_i']) / (4 * np.pi)
        hyp_ = -(ker['sum_i'] - c2b * ker['dif_i']) / (4 * np.pi)
        hzp_ = sb * ker['hz_ker'] / (4 * np.pi)

        out_e[:, 0] += mh * (ca * exp_ - sa * eyp_)
        out_e[:, 1] += mh * (sa * exp_ + ca * eyp_)
        out_e[:, 2] += mh * -ezp_
        out_h[:, 0] += mh * -(ca * hxp_ - sa * hyp_)
        out_h[:, 1] += mh * -(sa * hxp_ + ca * hyp_)
        out_h[:, 2] += mh * hzp_

    if abs(pz_down) > 0:
        fac = pz_down / (2 * np.pi * eta_v)
        e_rho = fac * ker['ved_e_rho']
        e_zd = fac / eta_v * ker['ved_e_z']
        h_phi = fac * ker['ved_h_phi']
        out_e[:, 0] += cphi * e_rho
        out_e[:, 1] += sphi * e_rho
        out_e[:, 2] += -e_zd
        out_h[:, 0] += sphi * h_phi
        out_h[:, 1] += -cphi * h_phi

    return out_e, out_h


def _mode_params(lam2, eta_h, eta_v, zeta, mode):
    """Vertical wavenumber and characteristic impedance per layer."""
    if mode == 'te':
        gam = np.sqrt(lam2 + zeta * eta_h)
        z0 = zeta / gam
    else:
        gam = np.sqrt((eta_h / eta_v) * lam2 + zeta * eta_h)
        z0 = gam / eta_h
    return gam, z0


def _reflection_tables(gam, z0, thick):
    """Global reflection coefficients at every layer's two boundaries.

    ``gam``/``z0``: (nlay, nlam), layer index 0 = top; ``thick``:
    (nlay,) with inf outer layers.  Voltage-wave convention: the local
    coefficient looking from layer i into layer j is
    (Z_j − Z_i)/(Z_j + Z_i); global responses by the standard recursion
    from the outermost halfspaces inwards.

    Returns ``(ra, rb)``, each (nlay, nlam): ``ra[i]`` seen looking up
    at the top boundary of layer i, ``rb[i]`` looking down at its
    bottom boundary (zero for the outer halfspaces' outer sides).
    """
    nlay = gam.shape[0]
    ra = np.zeros_like(gam)
    rb = np.zeros_like(gam)

    # rb[i]: looking down at interface (i | i+1); recursion upwards.
    for i in range(nlay - 2, -1, -1):
        rloc = (z0[i + 1] - z0[i]) / (z0[i + 1] + z0[i])
        if i == nlay - 2:
            rb[i] = rloc
        else:
            phase = np.exp(-2 * gam[i + 1] * thick[i + 1])
            rb[i] = ((rloc + rb[i + 1] * phase)
                     / (1 + rloc * rb[i + 1] * phase))

    # ra[i]: looking up at interface (i-1 | i); recursion downwards.
    for i in range(1, nlay):
        rloc = (z0[i - 1] - z0[i]) / (z0[i - 1] + z0[i])
        if i == 1:
            ra[i] = rloc
        else:
            phase = np.exp(-2 * gam[i - 1] * thick[i - 1])
            ra[i] = ((rloc + ra[i - 1] * phase)
                     / (1 + rloc * ra[i - 1] * phase))

    return ra, rb


def _tl_green(gam, z0, zif, thick, ra, rb, m, zs, n, zr, source,
              secondary_only):
    """TL Green's functions V(zr), I(zr) for a unit source at zs.

    ``gam``/``z0``/``ra``/``rb``: (nlay, nlam) mode tables (z-down,
    layer 0 on top); ``zif``: (nlay-1,) interface depths (z-down,
    ascending); ``m``/``n``: source/receiver layer indices;
    ``source``: 'i' (unit shunt current — horizontal dipoles) or
    'v' (unit series voltage — vertical dipoles);
    ``secondary_only``: exclude the direct wave (same-layer receivers
    add the analytic space-domain primary instead).
    """
    g = gam[m]
    z = z0[m]
    za = zif[m - 1] if m > 0 else None         # top of source layer
    zb = zif[m] if m < gam.shape[0] - 1 else None

    # Signed direct-wave values at the source-layer boundaries.
    # shunt current: V = (Z/2) e^{-Γ|z-zs|}          (symmetric V)
    # series voltage: V = (1/2) sgn(z-zs) e^{-Γ|z-zs|} (antisymmetric)
    eu = np.exp(-g * (zs - za)) if za is not None else 0.0 * g
    ed = np.exp(-g * (zb - zs)) if zb is not None else 0.0 * g
    if source == 'i':
        u = 0.5 * z * eu
        d = 0.5 * z * ed
    else:
        u = -0.5 * eu
        d = 0.5 * ed

    ra_m = ra[m]
    rb_m = rb[m]
    ee = (np.exp(-g * (zb - za))
          if (za is not None and zb is not None) else 0.0 * g)
    dd = 1.0 - ra_m * rb_m * ee ** 2

    # Up/down wave amplitudes in the source layer (A: down-going,
    # referenced at za; B: up-going, referenced at zb).
    a_amp = ra_m * (u + rb_m * ee * d) / dd
    b_amp = rb_m * (d + ra_m * ee * u) / dd

    if n == m:
        # Receiver in the source layer.
        e_a = a_amp * np.exp(-g * (zr - za)) if za is not None else 0.0 * g
        e_b = b_amp * np.exp(-g * (zb - zr)) if zb is not None else 0.0 * g
        v = e_a + e_b
        i = (e_a - e_b) / z
        if not secondary_only:
            edir = np.exp(-g * abs(zr - zs))
            sgn = np.sign(zr - zs) if zr != zs else 0.0
            if source == 'i':
                v = v + 0.5 * z * edir
                i = i + 0.5 * sgn * edir
            else:
                v = v + 0.5 * sgn * edir
                i = i + 0.5 * edir / z
        return v, i

    if n > m:
        # Walk DOWN: total V at the bottom boundary of the source layer.
        vcur = a_amp * ee + b_amp + d
        for k in range(m + 1, n):
            ph = np.exp(-gam[k] * thick[k])
            vcur = vcur * ph * (1 + rb[k]) / (1 + rb[k] * ph ** 2)
        # Inside the receiver layer n.
        ztop = zif[n - 1]
        gn = gam[n]
        if n < gam.shape[0] - 1:
            ph = np.exp(-gn * thick[n])
            den = 1 + rb[n] * ph ** 2
            e_dn = np.exp(-gn * (zr - ztop))
            e_up = rb[n] * ph * np.exp(-gn * (zif[n] - zr))
            v = vcur * (e_dn + e_up) / den
            i = vcur * (e_dn - e_up) / (z0[n] * den)
        else:
            e_dn = np.exp(-gn * (zr - ztop))
            v = vcur * e_dn
            i = vcur * e_dn / z0[n]
        return v, i

    # Walk UP: total V at the top boundary of the source layer.
    vcur = a_amp + b_amp * ee + u
    for k in range(m - 1, n, -1):
        ph = np.exp(-gam[k] * thick[k])
        vcur = vcur * ph * (1 + ra[k]) / (1 + ra[k] * ph ** 2)
    zbot = zif[n]
    gn = gam[n]
    if n > 0:
        ph = np.exp(-gn * thick[n])
        den = 1 + ra[n] * ph ** 2
        e_up = np.exp(-gn * (zbot - zr))
        e_dn = ra[n] * ph * np.exp(-gn * (zr - zif[n - 1]))
        v = vcur * (e_up + e_dn) / den
        i = vcur * (e_dn - e_up) / (z0[n] * den)
    else:
        e_up = np.exp(-gn * (zbot - zr))
        v = vcur * e_up
        i = -vcur * e_up / z0[n]
    return v, i


def fields_layered(src, receivers, depth, res_h, frequency, aniso=None,
                   filt=None):
    """E and H of an electric point dipole in a layered VTI medium.

    Parameters
    ----------
    src : array_like (x, y, z, azimuth, elevation)
        Electric point-dipole source of unit moment (z positive UP, as
        everywhere in emg3d).  Any orientation (tilted dipoles split
        into their horizontal and vertical moments).
    receivers : ndarray (n, 3)
        Receiver positions, in any layer.
    depth : array_like
        Interface depths (z, increasing; z positive up), size nlay-1.
        E.g. [-2000, 0] = halfspace below -2000, layer to 0, air above.
    res_h : array_like
        Horizontal resistivity per layer (size nlay, ordered from the
        bottom layer to the top layer).
    frequency : float
        Frequency (Hz), > 0.
    aniso : array_like, optional
        sqrt(res_v / res_h) per layer; default 1 (isotropic).  VTI is
        supported in every layer, including the source layer with
        same-layer receivers (the excluded primary is the closed-form
        VTI wholespace field).

    Returns
    -------
    efield, hfield : ndarray (n, 3)
        Complex E (V/m) and H (A/m) at the receivers.
    """
    from emg3d_tpu_torch.electrodes import rotation

    if filt is None:
        filt = transforms.design_hankel_filter()

    src = np.asarray(src, dtype=np.float64)
    receivers = np.atleast_2d(np.asarray(receivers, dtype=np.float64))

    # Convert to z-DOWN internally; layers ordered top (index 0) down.
    depth = np.sort(np.asarray(depth, dtype=np.float64))      # z-up asc.
    res_h = np.asarray(res_h, dtype=np.float64)
    nlay = res_h.size
    if depth.size != nlay - 1:
        raise ValueError("len(depth) must be len(res_h) - 1.")
    aniso = (np.ones(nlay) if aniso is None
             else np.asarray(aniso, dtype=np.float64))

    # z-down interface depths, descending z-up == ascending z-down.
    zif = -depth[::-1]                      # (nlay-1,) ascending z-down
    eta_h = (1.0 / res_h)[::-1]             # index 0 = top layer
    eta_v = eta_h / aniso[::-1] ** 2

    zs = -src[2]
    zr = -receivers[:, 2]

    # Layer index: layer i spans [zif[i-1], zif[i]] (z-down).
    def layer_of(z):
        return int(np.searchsorted(zif, z))

    ilay = layer_of(zs)

    thick = np.empty(nlay)
    thick[0] = np.inf
    thick[-1] = np.inf
    if nlay > 2:
        thick[1:-1] = np.diff(zif)

    omega = 2 * np.pi * frequency
    zeta = 1j * omega * const.mu_0

    # Horizontal offsets and azimuths.
    dx = receivers[:, 0] - src[0]
    dy = receivers[:, 1] - src[1]
    rho = np.sqrt(dx ** 2 + dy ** 2)
    rho = np.maximum(rho, 1e-9)
    cphi = dx / rho
    sphi = dy / rho

    # Wavenumbers: DLF evaluation points per receiver offset.
    lam = filt.base[None, :] / rho[:, None]          # (n, nb)

    out_e = np.zeros((receivers.shape[0], 3), dtype=np.complex128)
    out_h = np.zeros((receivers.shape[0], 3), dtype=np.complex128)

    # Source orientation (z-up frame); vertical moment flips sign in the
    # z-down frame.
    p = rotation(src[3], src[4])
    p_h = np.array([p[0], p[1]])
    mh = np.hypot(p_h[0], p_h[1])
    pz_down = -p[2]

    same_layer = [layer_of(z) == ilay for z in zr]

    j0 = filt.j0
    j1 = filt.j1

    for irec in range(receivers.shape[0]):
        l_ = lam[irec]
        l2 = l_ ** 2
        r_ = rho[irec]
        nrec_lay = layer_of(zr[irec])
        sec = nrec_lay == ilay   # same layer: secondary only + primary

        tables = {}
        for mode in ('te', 'tm'):
            gam = np.empty((nlay, l_.size), dtype=np.complex128)
            z0 = np.empty_like(gam)
            for i in range(nlay):
                gam[i], z0[i] = _mode_params(
                    l2, eta_h[i], eta_v[i], zeta, mode)
            ra, rb = _reflection_tables(gam, z0, thick)
            tables[mode] = (gam, z0, zif, thick, ra, rb)

        def h0(ker):
            return (ker / r_) @ j0

        def h1(ker):
            return (ker / r_) @ j1

        # J2 via recurrence: ∫ f J2 = ∫ f (2 J1/(λρ) − J0).
        def h2(ker):
            return 2.0 * ((ker / (l_ * r_)) / r_) @ j1 - h0(ker)

        eta_v_r = eta_v[nrec_lay]

        # ---- Horizontal moment: shunt-current TL sources, both modes.
        if mh > 0:
            vte, ite = _tl_green(*tables['te'], ilay, zs, nrec_lay,
                                 zr[irec], 'i', sec)
            vtm, itm = _tl_green(*tables['tm'], ilay, zs, nrec_lay,
                                 zr[irec], 'i', sec)

            # Spectral fields (Michalski-Zheng formulation C):
            #   Ex ~ -(1/4π)[(VTE+VTM) λ J0 + cos2φ (VTE−VTM) λ J2]
            #   Ey ~ -(1/4π) sin2φ (VTE−VTM) λ J2
            #   Ez ~ +(1/4π)(λ²/η_v(zr)) I^TM · 2cosφ J1
            sum_v = h0(l_ * (vte + vtm))
            dif_v = h2(l_ * (vte - vtm))
            sum_i = h0(l_ * (ite + itm))
            dif_i = h2(l_ * (ite - itm))
            ez_ker = 2.0 * h1(l2 / eta_v_r * itm)
            hz_ker = 2.0 * h1(l2 / zeta * vte)

            ca = p_h[0] / mh   # source-orientation cos/sin (horizontal)
            sa = p_h[1] / mh
            # Rotate receiver azimuth into the source frame.
            cb = cphi[irec] * ca + sphi[irec] * sa
            sb = -cphi[irec] * sa + sphi[irec] * ca
            c2b = cb * cb - sb * sb
            s2b = 2 * sb * cb

            # Fields in the source frame (x' along the dipole).
            exp_ = -(sum_v + c2b * dif_v) / (4 * np.pi)
            eyp_ = -(s2b * dif_v) / (4 * np.pi)
            ezp_ = cb * ez_ker / (4 * np.pi)

            hxp_ = (s2b * dif_i) / (4 * np.pi)
            hyp_ = -(sum_i - c2b * dif_i) / (4 * np.pi)
            hzp_ = sb * hz_ker / (4 * np.pi)

            # Rotate back to the global (z-up) frame.  The internal
            # frame is the z-mirrored one (improper transform,
            # S = diag(1, 1, -1)): E is a polar vector (E' = S E), H an
            # axial vector (H' = det(S)·S H = diag(-1, -1, 1) H).
            out_e[irec, 0] += mh * (ca * exp_ - sa * eyp_)
            out_e[irec, 1] += mh * (sa * exp_ + ca * eyp_)
            out_e[irec, 2] += mh * -ezp_
            out_h[irec, 0] += mh * -(ca * hxp_ - sa * hyp_)
            out_h[irec, 1] += mh * -(sa * hxp_ + ca * hyp_)
            out_h[irec, 2] += mh * hzp_

        # ---- Vertical moment (z-down): series-voltage TM source of
        # spectral amplitude λ/(2π η_v(zs)); fields
        #   E_ρ = (1/2π η_v(zs)) ∫ λ² V_v J1 dλ
        #   E_z = (1/2π η_v(zs) η_v(zr)) ∫ λ³ I_v J0 dλ
        #   H_φ = (1/2π η_v(zs)) ∫ λ² I_v J1 dλ
        if abs(pz_down) > 0:
            vv, iv = _tl_green(*tables['tm'], ilay, zs, nrec_lay,
                               zr[irec], 'v', sec)
            fac = pz_down / (2 * np.pi * eta_v[ilay])
            e_rho = fac * h1(l2 * vv)
            e_zd = fac / eta_v_r * h0(l2 * l_ * iv)
            h_phi = fac * h1(l2 * iv)

            out_e[irec, 0] += cphi[irec] * e_rho
            out_e[irec, 1] += sphi[irec] * e_rho
            out_e[irec, 2] += -e_zd                    # z-up output
            # Internal φ̂ (z-down frame) = (−sinφ, cosφ); H is axial,
            # so its horizontal components flip in the z-up frame.
            out_h[irec, 0] += sphi[irec] * h_phi
            out_h[irec, 1] += -cphi[irec] * h_phi

    # Analytic space-domain primary (direct) field for receivers in the
    # source layer — the wavenumber kernels above carry reflections
    # only there (the direct term decays too slowly in λ).  The VTI
    # wholespace closed form handles an anisotropic source layer.
    if any(same_layer):
        sel = np.asarray(same_layer)
        rvec = receivers[sel] - src[:3][None, :]
        e_p, h_p = _vti_fullspace_primary(
            rvec, p, eta_h[ilay], eta_v[ilay], zeta)
        out_e[sel] += e_p
        out_h[sel] += h_p

    return out_e, out_h


def dipole_layered(src, receivers, depth, res_h, frequency, aniso=None,
                   rec_type='electric'):
    """Receiver responses of a unit dipole in a layered medium.

    Like :func:`fields_layered`, but projects onto oriented point
    receivers given as (x, y, z, azimuth, elevation) tuples and returns
    one complex response per receiver.
    """
    from emg3d_tpu_torch.electrodes import rotation

    receivers = np.atleast_2d(np.asarray(receivers, dtype=np.float64))
    e, h = fields_layered(src, receivers[:, :3], depth, res_h, frequency,
                          aniso=aniso)
    out = np.empty(receivers.shape[0], dtype=np.complex128)
    fld = e if rec_type == 'electric' else h
    for i, rec in enumerate(receivers):
        out[i] = fld[i] @ rotation(rec[3], rec[4])
    return out
