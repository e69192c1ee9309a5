"""Multigrid solver for 3-D electromagnetic diffusion (PyTorch).

Port of ``emg3d_tpu.solver`` on one device: MG-preconditioned Krylov
solvers (BiCGSTAB, CGS, GCROT(m,k)) and stand-alone multigrid (V, W or F
cycles), with semicoarsening and line relaxation (by default BiCGSTAB,
semicoarsening cycling over [1, 2, 3] and line relaxation over [4, 5, 6]).

- The hierarchies (coarse grids, restricted model, transfer weights) are
  built on the host per semicoarsening direction and placed on
  ``device`` as one :class:`_Level` per grid; the line-relaxation
  direction only changes the per-level smoother flags
  (:class:`_Hierarchies`).
- The cycle is host-driven and eager: smoothing phases (the ``gs_phase``
  and ``line_phase`` kernels on CUDA), residual + restriction, recursion,
  prolongation.
- Multigrid accumulates its iterate as an unevaluated sum ``e_hi + e_lo``
  with an error-free two-sum, and the residual that decides convergence
  is evaluated in native complex128/float64, so a complex64 solve reaches
  tolerances below float32 resolution.
- The Krylov vectors live in complex128/float64 on the device; only the
  multigrid preconditioner runs in the working precision.
"""

import itertools
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import scipy as sp
import torch

from emg3d_tpu_torch import config, fields, meshes, models, utils
from emg3d_tpu_torch.ops import operator, smoothers, transfer

__all__ = ['solve', 'solve_source', 'multigrid', 'krylov', 'smoothing',
           'restriction', 'prolongation', 'residual', 'MGParameters',
           'RegularGridProlongator']


# ==========================================================================
# Public entry points.
# ==========================================================================

def solve(model, sfield, sslsolver=True, semicoarsening=True,
          linerelaxation=True, verb=0, **kwargs):
    """Solve the 3-D electromagnetic diffusion equation.

    Same signature and semantics as ``emg3d_tpu.solver.solve`` (reference
    emg3d/solver.py:52-449): MG-preconditioned BiCGSTAB with
    semicoarsening and line relaxation by default; ``plain=True`` for
    stand-alone multigrid F-cycles.  Two more keywords:

    - ``device``: where the solve runs.  The default (None) is the CUDA
      card; without a card it raises ``RuntimeError``.  Pass
      ``device='cpu'`` to run on the CPU.  Every hierarchy tensor is
      placed there.
    - ``dtype``: device working dtype of the multigrid (default
      complex64/float32 on CUDA, complex128/float64 on the CPU).

    Returns the electric field (and an info dict if ``return_info``).
    """
    always_return = kwargs.pop('always_return', False)

    if kwargs.pop('plain', False):
        sslsolver = False if sslsolver is True else sslsolver
        semicoarsening = False if semicoarsening is True else semicoarsening
        linerelaxation = False if linerelaxation is True else linerelaxation
    efield = kwargs.pop('efield', None)

    var = MGParameters(
        sslsolver=sslsolver, semicoarsening=semicoarsening,
        linerelaxation=linerelaxation, shape_cells=model.shape, verb=verb,
        **kwargs)

    var.cprint(f"\n:: emg3d-tpu-torch START :: {var.time.now} ::\n", 2)
    var.cprint(var, 2)

    # Reference error (norm of b).
    var.l2_refe = float(sp.linalg.norm(sfield.field, check_finite=False))
    var.error_at_cycle[0] = var.l2_refe

    if sfield.frequency is None:
        raise ValueError(
            "Source field is missing frequency information; create it "
            "with `emg3d_tpu_torch.fields.get_source_field`.")

    vmodel = models.VolumeModel(model, sfield)

    info = ''
    if efield is None:
        efield = fields.Field(model.grid, dtype=sfield.field.dtype,
                              frequency=sfield._frequency)
        var.do_return = True
    else:
        if sfield.field.dtype != efield.field.dtype:
            raise ValueError(
                "Source field and electric field must have the same dtype; "
                f"sfield: {sfield.field.dtype}; efield: "
                f"{efield.field.dtype}.")
        if efield._frequency is None:
            efield._frequency = sfield._frequency

        # Enforce PEC on the provided initial field.
        efield.fx[:, 0, :] = efield.fx[:, -1, :] = 0.
        efield.fx[:, :, 0] = efield.fx[:, :, -1] = 0.
        efield.fy[0, :, :] = efield.fy[-1, :, :] = 0.
        efield.fy[:, :, 0] = efield.fy[:, :, -1] = 0.
        efield.fz[0, :, :] = efield.fz[-1, :, :] = 0.
        efield.fz[:, 0, :] = efield.fz[:, -1, :] = 0.

        var.do_return = always_return

        # Already good enough?
        var.l2 = residual(vmodel, sfield, efield, True, device=var.device)
        if var.l2 < var.tol * var.l2_refe:
            var.sslsolver = None
            var.cycle = None
            var.exit_message = "CONVERGED"
            info = "   > NOTHING DONE (provided efield already good enough)\n"

    # Zero source -> zero field.
    if var.l2_refe < 100 * np.finfo(np.float64).tiny:
        var.l2_refe = np.nan
        var.sslsolver = None
        var.cycle = None
        var.exit_message = "CONVERGED"
        info = "   > RETURN ZERO E-FIELD (provided sfield is zero)\n"
        efield = fields.Field(model.grid, dtype=sfield.field.dtype,
                              frequency=sfield._frequency)

    if var.sslsolver:
        krylov(vmodel, sfield, efield, var)
    elif var.cycle:
        multigrid(vmodel, sfield, efield, var)

    exit_status = int(var.exit_message != 'CONVERGED')

    if var.verb > 2:
        if var.sslsolver:
            info = f"   > Solver steps     : {var.ssl_it}\n"
            if var.cycle:
                info += f"   > MG prec. steps   : {var.it}\n"
        elif var.cycle:
            info = f"   > MG cycles        : {var.it}\n"
        info += f"   > Final rel. error : {var.l2/var.l2_refe:.3e}\n\n"
        info += f":: emg3d-tpu-torch END :: {var.time.now} :: "
        info += f"runtime = {var.time.runtime}\n"
        var.cprint(info, 2)
    elif var.verb == 0 and exit_status == 1:
        var.cprint(f"* WARNING :: {var.exit_message}", -1)

    if var.return_info:
        info_dict = {
            'exit': exit_status,
            'exit_message': var.exit_message,
            'abs_error': var.l2,
            'rel_error': var.l2 / var.l2_refe,
            'ref_error': var.l2_refe,
            'tol': var.tol,
            'it_mg': var.it,
            'it_ssl': var.ssl_it,
            'time': var.runtime_at_cycle[-1],
            'runtime_at_cycle': var.runtime_at_cycle,
            'error_at_cycle': var.error_at_cycle,
            'log': var.log_message,
        }

    if var.do_return and var.return_info:
        return efield, info_dict
    elif var.do_return:
        return efield
    elif var.return_info:
        return info_dict


def solve_source(model, source, frequency, **kwargs):
    """Shortcut: build the source field, then solve (solver.py:452-467)."""
    sfield = fields.get_source_field(model.grid, source, frequency)
    return solve(model, sfield, **kwargs)


# ==========================================================================
# Host <-> device.
# ==========================================================================

def _field_to_dev(field, device, dtype):
    """Field -> tuple of C-contiguous device tensors of ``dtype``.

    The Field's components are Fortran-ordered views: they are made
    C-contiguous before the copy.
    """
    return tuple(
        torch.from_numpy(np.ascontiguousarray(f)).to(device=device,
                                                     dtype=dtype)
        for f in (field.fx, field.fy, field.fz))


def _dev_to_field(e, grid, frequency, dtype):
    """Tuple of device tensors -> Field (host)."""
    out = fields.Field(grid, dtype=dtype, frequency=frequency)
    out.fx = e[0].cpu().numpy().astype(dtype)
    out.fy = e[1].cpu().numpy().astype(dtype)
    out.fz = e[2].cpu().numpy().astype(dtype)
    return out


def _host_dtypes(vmodel):
    """(field dtype, real dtype) of the host precision for ``vmodel``."""
    if np.iscomplexobj(vmodel.eta_x):
        return torch.complex128, torch.float64
    return torch.float64, torch.float64


def _level_tensors(eta_x, eta_y, eta_z, zeta, h, device, dtypes):
    """(eta_x, eta_y, eta_z, zeta, hx, hy, hz) as device tensors."""
    cdt, rdt = dtypes

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dt)

    return (dev(eta_x, cdt), dev(eta_y, cdt), dev(eta_z, cdt),
            dev(zeta, rdt), dev(h[0], rdt), dev(h[1], rdt), dev(h[2], rdt))


# ==========================================================================
# Hierarchy construction (host-side, per semicoarsening direction).
# ==========================================================================

@dataclass
class _Level:
    """Tensors of one multigrid level on the device.

    ``ops`` are (eta_x, eta_y, eta_z, zeta, hx, hy, hz) in working
    precision.  ``rw`` (per-axis restriction weights) and ``pm`` (per-axis
    prolongation (idx, w)) describe the transfer to the next coarser
    level; they are None on the coarsest.  ``ops64`` (level 0 only) holds
    the operator in complex128/float64 for the residual that decides
    convergence and for the Krylov matrix-vector product.

    A level of the batch engine (:mod:`emg3d_tpu_torch.parallel.batch`)
    holds eta for a leading task axis: stacked ``(B, nx, ny, nz)``, or
    shared with the per-task ``scale`` (B,) in working precision and
    ``scale64`` in the precision of ``ops64`` (task k's eta is
    ``scale[k]`` times the shared one).
    """

    ops: tuple
    rw: Optional[tuple] = None
    pm: Optional[tuple] = None
    ops64: Optional[tuple] = None
    scale: Optional[torch.Tensor] = None
    scale64: Optional[torch.Tensor] = None


def _current_sc_dir(sc_dir, shape):
    """Effective semicoarsening direction for this grid's shape.

    Mirrors reference solver.py:1482-1531.
    """
    xsc = shape[0] % 2 != 0 or shape[0] < 3 or sc_dir == 1
    ysc = shape[1] % 2 != 0 or shape[1] < 3 or sc_dir == 2
    zsc = shape[2] % 2 != 0 or shape[2] < 3 or sc_dir == 3

    if xsc:
        if ysc:
            return 6
        elif zsc:
            return 5
        else:
            return 1
    elif ysc:
        if zsc:
            return 4
        else:
            return 2
    elif zsc:
        return 3
    return 0


def _current_lr_dir(lr_dir, shape):
    """Effective line-relaxation direction (reference solver.py:1534-1588)."""
    c = int(lr_dir)
    if shape[0] == 2:
        c = {1: 0, 5: 3, 6: 2, 7: 4}.get(c, c)
    if shape[1] == 2:
        c = {2: 0, 4: 3, 6: 1, 7: 5}.get(c, c)
    if shape[2] == 2:
        c = {3: 0, 4: 2, 5: 1, 7: 6}.get(c, c)
    return c


def _coarsen_flags(c_sc_dir):
    """(bool, bool, bool): which axes get coarsened (solver.py:891-897)."""
    return (c_sc_dir not in [1, 5, 6],
            c_sc_dir not in [2, 4, 6],
            c_sc_dir not in [3, 4, 5])


def _build_hierarchy(vmodel, sc_dir, lr_dir, clevel_max, device, dtypes):
    """Build the per-level device tensors for one sc_dir, finest first.

    Returns ``(meta, levels)``: ``meta`` holds per level the static
    ``(shape, c_lr_dir, coarsen)`` (``coarsen`` is None on the coarsest),
    ``levels`` the :class:`_Level` tensors.  Model restriction is the
    2/4/8-cell sum of the reference (solver.py:1667-1718), on the host in
    float64/complex128; weights per Muld06 Eq. 9.
    """
    rdt = dtypes[1]
    eta_x = np.asarray(vmodel.eta_x)
    eta_y = np.asarray(vmodel.eta_y)
    eta_z = np.asarray(vmodel.eta_z)
    zeta = np.asarray(vmodel.zeta)
    h = [np.asarray(vmodel.grid.h[i]) for i in range(3)]
    origin = np.asarray(vmodel.grid.origin)

    def dev(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dt)

    meta, levels = [], []
    for level in range(clevel_max + 1):
        grid = meshes.BaseMesh(h, origin)
        shape = tuple(grid.shape_cells)
        lvl = _Level(_level_tensors(eta_x, eta_y, eta_z, zeta, h, device,
                                    dtypes))
        if level == 0:
            host = _host_dtypes(vmodel)
            lvl.ops64 = (lvl.ops if host == dtypes else _level_tensors(
                eta_x, eta_y, eta_z, zeta, h, device, host))
        levels.append(lvl)
        if level == clevel_max:
            meta.append((shape, _current_lr_dir(lr_dir, shape), None))
            break

        # Coarsen for the next level.
        coarsen = _coarsen_flags(_current_sc_dir(sc_dir, shape))
        meta.append((shape, _current_lr_dir(lr_dir, shape), coarsen))
        ch = [np.diff(np.r_[0., h[i].cumsum()][::2]) if coarsen[i] else h[i]
              for i in range(3)]
        cgrid = meshes.BaseMesh(ch, origin)

        rw, pm = [], []
        for i, coord in enumerate('xyz'):
            if coarsen[i]:
                nodes = getattr(grid, 'nodes_' + coord)
                cnodes = getattr(cgrid, 'nodes_' + coord)
                w = transfer.restrict_weights(
                    nodes, getattr(grid, 'cell_centers_' + coord), h[i],
                    cnodes, getattr(cgrid, 'cell_centers_' + coord), ch[i])
                rw.append(tuple(dev(x, rdt) for x in w))
                idx, wp = transfer.prolong_meta(cnodes, nodes)
                pm.append((dev(idx), dev(wp, rdt)))
            else:
                rw.append(None)
                pm.append(None)
        lvl.rw, lvl.pm = tuple(rw), tuple(pm)

        # Restrict model parameters (host numpy).
        eta_x = transfer.restrict_model_parameters(eta_x, coarsen)
        eta_y = transfer.restrict_model_parameters(eta_y, coarsen)
        eta_z = transfer.restrict_model_parameters(eta_z, coarsen)
        zeta = transfer.restrict_model_parameters(zeta, coarsen)
        h = ch

    return tuple(meta), levels


class _Hierarchies:
    """Per-solve cache of multigrid hierarchies per (sc_dir, lr_dir).

    The level tensors depend only on sc_dir; lr_dir only changes the
    static per-level c_lr_dir flags, so the tensors are shared across
    the line-relaxation cycling values (e.g. '456').
    """

    def __init__(self, vmodel, var):
        self.vmodel = vmodel
        self.var = var
        self.dtypes = config.working_dtypes(
            var.device, np.iscomplexobj(vmodel.eta_x), var.dtype)
        self._cache = {}
        self._acache = {}

    def get(self, sc_dir, lr_dir):
        key = (int(sc_dir), int(lr_dir))
        if key not in self._cache:
            akey = int(sc_dir)
            if akey not in self._acache:
                self._acache[akey] = self._build(
                    sc_dir, lr_dir, self.var.clevel[min(akey, 3)])
            meta0, levels = self._acache[akey]
            meta = tuple((shape, _current_lr_dir(lr_dir, shape), coarsen)
                         for shape, _, coarsen in meta0)
            self._cache[key] = (meta, levels)
        return self._cache[key]

    def _build(self, sc_dir, lr_dir, clevel_max):
        return _build_hierarchy(self.vmodel, sc_dir, lr_dir, clevel_max,
                                self.var.device, self.dtypes)


# ==========================================================================
# Level operations.
# ==========================================================================

# (axis, the c_lr_dir values that relax lines along it), in the order
# the line smoother runs them.
LINE_AXES = ((0, (1, 5, 6, 7)), (1, (2, 4, 6, 7)), (2, (3, 4, 5, 7)))


def _smooth(e, s, lvl, c_lr_dir, nu):
    """Smoothing dispatch (reference solver.py:788-846), in place on e.

    The point smoother at ``c_lr_dir == 0``; otherwise the line smoother
    along each axis that ``c_lr_dir`` names, each completing its nu
    sweeps before the next one runs.
    """
    if c_lr_dir == 0:
        e = smoothers.gauss_seidel(*e, *s, *lvl.ops, nu, lvl.scale)
    for axis, dirs in LINE_AXES:
        if c_lr_dir in dirs:
            e = smoothers.gauss_seidel_line(*e, *s, *lvl.ops, nu, axis,
                                            lvl.scale)
    return e


def _scaled(ops, scale):
    """``ops`` with every task's eta: ``scale[k] * eta`` for a shared eta
    with a per-task scale; unchanged without a scale."""
    if scale is None:
        return ops
    sc = scale[:, None, None, None]
    return (*(sc * c for c in ops[:3]), *ops[3:])


def _restrict(e, s, lvl, coarsen):
    """Residual + restriction -> (coarse source, zero coarse guess)."""
    res = operator.residual(*s, *e, *_scaled(lvl.ops, lvl.scale))
    cs = transfer.restrict(*res, lvl.rw, coarsen)
    return cs, tuple(torch.zeros_like(c) for c in cs)


def _prolong(e, ce, lvl, coarsen):
    """Add the prolonged coarse correction to e, in place."""
    return transfer.prolong(*e, *ce, lvl.pm, coarsen)


def _residual_norm_split(e_hi, e_lo, s, lvl, per_task=False):
    """Residual r = s - A (e_hi + e_lo) and its norm, in double precision.

    The split iterate and the source are promoted to complex128/float64
    and the residual is evaluated with the level-0 operator in that
    precision (``_residual_norm_split_f64_jit`` of the JAX package; no
    double-single arithmetic is needed on hardware with FP64), a shared
    eta scaled by ``scale64``.  Returns the residual in working precision
    and the norm as a float, or with ``per_task`` the norms of a task
    axis as a (B,) device tensor.
    """
    ops64 = _scaled(lvl.ops64, lvl.scale64)
    up = ops64[0].dtype
    e = tuple(h.to(up) + l.to(up) for h, l in zip(e_hi, e_lo))
    r = operator.residual(*(c.to(up) for c in s), *e, *ops64)
    l2 = operator.residual_norm(*r, per_task=per_task)
    return tuple(c.to(e_hi[0].dtype) for c in r), (l2 if per_task
                                                   else float(l2))


def _accumulate_(e_hi, e_lo, de):
    """(e_hi, e_lo) += de with an error-free fast-two-sum, IN PLACE.

    Keeps the multigrid corrections from rounding away once they are
    ~eps-relative to the field, the mechanism that otherwise floors a
    float32 solve at ~1e-5 relative residual.
    """
    for hi, lo, d in zip(e_hi, e_lo, de):
        t = lo + d
        hi2 = hi + t
        lo.copy_(t - (hi2 - hi))
        hi.copy_(hi2)


def _cycle_correction(meta, levels, r, var, first):
    """One multigrid cycle applied to residual ``r`` from a zero guess.

    The cycle is a linear stationary iteration, so running it on (A, r)
    from zero and adding the result to the iterate equals the
    reference's in-place form (solver.py:471-649), while letting the
    caller accumulate in split precision.  Includes the F-cycle's
    decreasing-cycmax mechanics (reference solver.py:519-526) and the
    coarsest-grid Gauss-Seidel solve (solver.py:566-578).  Returns the
    correction ``de``.  The batch engine runs the same cycle on its
    levels with a task axis.
    """
    nlevels = len(meta)
    cycle = var.cycle
    cycmax0 = var.cycmax

    def track_smooth(e, s, level, nu):
        # The level trace feeds the verb>3 cycle-QC visualization.
        var.level_all.append(level)
        return _smooth(e, s, levels[level], meta[level][1], nu)

    def recurse(s, e, level, new_cycmax):
        lvl, coarsen = levels[level], meta[level][2]
        if level == nlevels - 1:
            cycmax = 1
        elif new_cycmax == 0 or cycle != 'F':
            cycmax = cycmax0
        else:
            cycmax = new_cycmax

        it = 0
        cyc = 0
        while it < cycmax:
            if level == nlevels - 1:
                # Coarsest grid: Gauss-Seidel as direct-ish solver.
                e = track_smooth(e, s, level, var.nu_coarse)
            else:
                if var.nu_pre > 0:
                    e = track_smooth(e, s, level, var.nu_pre)
                cs, ce = _restrict(e, s, lvl, coarsen)
                ce = recurse(cs, ce, level + 1, cycmax - cyc)
                e = _prolong(e, ce, lvl, coarsen)
                if var.nu_post > 0:
                    e = track_smooth(e, s, level, var.nu_post)
            it += 1
            cyc += 1
        return e

    de = tuple(torch.zeros_like(c) for c in r)

    if first and var.nu_init > 0:
        de = track_smooth(de, r, 0, var.nu_init)

    if nlevels == 1:
        de = track_smooth(de, r, 0, var.nu_coarse)
    else:
        if var.nu_pre > 0:
            de = track_smooth(de, r, 0, var.nu_pre)
        cs, ce = _restrict(de, r, levels[0], meta[0][2])
        ce = recurse(cs, ce, 1, cycmax0)
        de = _prolong(de, ce, levels[0], meta[0][2])
        if var.nu_post > 0:
            de = track_smooth(de, r, 0, var.nu_post)

    return de


def _cycle_qc(var):
    """ASCII rendering of the first multigrid cycle's level walk.

    Shown at verb>3 after the first cycle (reference
    solver.py:1817-1843): each grid-spacing row draws a ``\\`` where
    the cycle restricts through that level and a ``/`` where it
    prolongates back, tracing the V/W/F shape from ``var.level_all``.
    """
    levels = np.asarray(var.level_all, dtype=np.int64)
    if levels.size < 2:
        return ""

    steps = levels[1:] - levels[:-1]            # +1 down, -1 up
    mids = np.minimum(levels[1:], levels[:-1]) + 1   # level row crossed
    shown = min(steps.size, 70)

    rows = ["       h_"]
    for row in range(1, int(levels.max()) + 1):
        chars = "".join(
            "\\" if (mids[i] == row and steps[i] > 0)
            else "/" if (mids[i] == row and steps[i] < 0)
            else " " for i in range(shown))
        rows.append(f"   {2 ** row:4}h_ {chars}")
    out = "\n".join(rows) + "\n\n"
    if steps.size > 70:
        out += (f"  (Cycle-QC restricted to first 70 of "
                f"{steps.size} steps.)\n")
    return out


def _next_dirs(var):
    """The (sc_dir, lr_dir) of the next cycle (solver.py:639-642)."""
    sc_next = next(var.sc_cycle) if var.sc_cycle else var.sc_dir
    lr_next = next(var.lr_cycle) if var.lr_cycle else var.lr_dir
    return sc_next, lr_next


def _after_first_cycle(var):
    if var.first_cycle:
        var.first_cycle = False
        if var.verb > 3:
            var.cprint(_cycle_qc(var), 3)


# ==========================================================================
# Host-driven multigrid and Krylov solvers.
# ==========================================================================

class _ConvergenceError(Exception):
    """Raised to force-abort the outer Krylov solver."""


def multigrid(model, sfield, efield, var):
    """Run multigrid cycles until a termination criterion fires.

    Host-driven outer loop; mirrors the level-0 loop of reference
    solver.py:471-649, cycling the semicoarsening and line-relaxation
    directions.  ``model`` is a VolumeModel; ``sfield``/``efield`` are
    Fields (efield is updated in place).
    """
    hier = _Hierarchies(model, var)
    meta, levels = hier.get(var.sc_dir, var.lr_dir)
    wdt = hier.dtypes[0]

    s = _field_to_dev(sfield, var.device, wdt)
    e_hi = _field_to_dev(efield, var.device, wdt)
    e_lo = tuple(torch.zeros_like(c) for c in e_hi)

    r, l2_last = _residual_norm_split(e_hi, e_lo, s, levels[0])
    l2_stag = np.ones(var.maxcycle) * l2_last

    it = 0
    first = True
    while True:
        l2_prev = l2_last
        l2_stag[(it - 1) % var.maxcycle] = l2_last

        # Cycle semicoarsening and line-relaxation directions (applied
        # to the NEXT residual evaluation, reference solver.py:639-642).
        sc_next, lr_next = _next_dirs(var)

        de = _cycle_correction(meta, levels, r, var, first)
        _accumulate_(e_hi, e_lo, de)
        meta, levels = hier.get(sc_next, lr_next)
        r, l2_last = _residual_norm_split(e_hi, e_lo, s, levels[0])
        var.sc_dir, var.lr_dir = sc_next, lr_next
        _after_first_cycle(var)
        first = False

        it += 1
        var.it += 1

        var.runtime_at_cycle = np.r_[var.runtime_at_cycle, var.time.elapsed]
        var.error_at_cycle = np.r_[var.error_at_cycle, l2_last]

        if var.verb > 3:
            var.cprint(
                f"   [{var.time.now}]   {l2_last/var.l2_refe:.3e} "
                f"after {var.it:3} {var.cycle}-cycles   "
                f"[{l2_last:.3e}, {l2_last/max(l2_prev, 1e-300):.3f}]"
                f"   {var.lr_dir} {var.sc_dir}", 3)

        if _terminate(var, l2_last, l2_stag[(it - 1) % var.maxcycle], it):
            break

    var.l2 = l2_last

    # Combine the split field on the host in the Field's (float64)
    # dtype so the achieved algebraic accuracy survives the export.
    dtype = efield.field.dtype
    out = fields.Field(efield.grid, dtype=dtype, frequency=efield._frequency)
    out.fx, out.fy, out.fz = (
        h.cpu().numpy().astype(dtype) + lo.cpu().numpy().astype(dtype)
        for h, lo in zip(e_hi, e_lo))
    efield.field = out.field


def _terminate(var, l2_last, l2_stag, it):
    """Termination criteria (reference solver.py:1591-1664)."""
    finished = False
    sslabort = False

    if l2_last < var.tol * var.l2_refe:
        var.exit_message = "CONVERGED"
        finished = True
    elif l2_last > 10 * var.l2_refe or not np.isfinite(l2_last):
        var.exit_message = "DIVERGED"
        finished = True
        sslabort = True
    elif it > 2 and l2_last >= l2_stag:
        var.exit_message = "STAGNATED"
        finished = True
        sslabort = True
    elif it == var.maxit:
        if not var.sslsolver:
            var.exit_message = "MAX. ITERATION REACHED, NOT CONVERGED"
        finished = True

    if finished:
        if var.sslsolver and sslabort:
            raise _ConvergenceError
        elif not var.sslsolver:
            var.cprint("   > " + var.exit_message, 2)

    return finished


def krylov(model, sfield, efield, var):
    """MG-preconditioned Krylov solver (reference solver.py:652-784).

    'bicgstab', 'cgs' and 'gcrotmk' run with device-side vectors in
    complex128/float64; only O(1) scalars (inner products, small
    least-squares systems) touch the host.  The multigrid preconditioner
    runs in the working precision from a zero guess.
    """
    hier = _Hierarchies(model, var)
    ops64 = hier.get(var.sc_dir, var.lr_dir)[1][0].ops64
    hdt = ops64[0].dtype
    wdt = hier.dtypes[0]

    def amatvec(e):
        return operator.amat_x(*e, *ops64)

    def mg_precond(s):
        """Apply up-to-maxcycle MG cycles to s, starting from zero.

        Mirrors the reference's use of multigrid as the preconditioner
        (solver.py:710-728), incl. the divergence/stagnation abort of the
        outer Krylov solver via _ConvergenceError.
        """
        r = tuple(c.to(wdt) for c in s)
        e_hi = tuple(torch.zeros_like(c) for c in r)
        e_lo = tuple(torch.zeros_like(c) for c in r)
        l2_stag = np.ones(var.maxcycle) * np.inf
        it = 0
        first = True
        l2_refe = None
        while True:
            sc_next, lr_next = _next_dirs(var)
            meta, levels = hier.get(var.sc_dir, var.lr_dir)
            last = it + 1 == var.maxit

            de = _cycle_correction(meta, levels, r, var, first)
            _accumulate_(e_hi, e_lo, de)
            if not last:
                _, levels2 = hier.get(sc_next, lr_next)
                r, l2_last = _residual_norm_split(e_hi, e_lo, s, levels2[0])
            var.sc_dir, var.lr_dir = sc_next, lr_next
            _after_first_cycle(var)
            first = False
            it += 1
            var.it += 1

            if it == var.maxit:
                break
            if l2_refe is None:
                l2_refe = max(l2_last, 1e-300)

            # Inner termination (maxit = maxcycle when preconditioning).
            if l2_last < var.tol * var.l2_refe:
                break
            if l2_last > 10 * l2_refe or not np.isfinite(l2_last):
                var.exit_message = "DIVERGED"
                raise _ConvergenceError
            if it > 2 and l2_last >= l2_stag[(it - 1) % var.maxcycle]:
                var.exit_message = "STAGNATED"
                raise _ConvergenceError
            l2_stag[(it - 1) % var.maxcycle] = l2_last
        return tuple(h.to(hdt) + lo.to(hdt) for h, lo in zip(e_hi, e_lo))

    def callback():
        var.ssl_it += 1
        var.runtime_at_cycle = np.r_[var.runtime_at_cycle, var.time.elapsed]
        var.error_at_cycle = np.r_[var.error_at_cycle, var.l2]
        if var.verb > 3:
            var.cprint(
                f"   [{var.time.now}]   {var.l2/var.l2_refe:.3e} "
                f" after {var.ssl_it:3} {var.sslsolver}-cycles", 3)

    s = _field_to_dev(sfield, var.device, hdt)
    e = _field_to_dev(efield, var.device, hdt)

    native = {'bicgstab': _bicgstab, 'cgs': _cgs,
              'gcrotmk': _gcrotmk}[var.sslsolver]
    try:
        e, i = native(amatvec, mg_precond if var.cycle else None, s, e,
                      var, callback)
    except _ConvergenceError:
        i = -1
        e = tuple(torch.zeros_like(c) for c in s)
        var.exit_message += " (returned field is zero)"

    if i < 0:
        if var.exit_message == '':
            var.exit_message = f"Error in {var.sslsolver} ({i})"
    elif i > 0:
        var.exit_message = "MAX. ITERATION REACHED, NOT CONVERGED"
    else:
        var.exit_message = "CONVERGED"
    var.cprint("   > " + var.exit_message, 2)

    out = _dev_to_field(e, efield.grid, efield._frequency,
                        efield.field.dtype)
    efield.field = out.field


def _dot(a, b):
    """Conjugated inner product over field tuples (complex, or float for
    real tensors)."""
    val = sum(torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b))
    return complex(val) if a[0].is_complex() else float(val)


def _norm_tup(a):
    return float(torch.sqrt(sum(torch.sum(torch.abs(x) ** 2) for x in a)))


def _axpy(a, alpha, b):
    """a + alpha*b over tuples (alpha taken real for real tensors)."""
    alpha = complex(alpha) if a[0].is_complex() else float(np.real(alpha))
    return tuple(x + alpha * y for x, y in zip(a, b))


def _one(b):
    """The scalar 1 of the field type of ``b``."""
    return 1.0 + 0j if b[0].is_complex() else 1.0


def _bicgstab(amatvec, precond, b, x0, var, callback):
    """Preconditioned BiCGSTAB with device-side vectors.

    Standard right-preconditioned BiCGSTAB (van der Vorst); matches the
    role of scipy.sparse.linalg.bicgstab in the reference
    (solver.py:759-765).  Returns (x, info).
    """
    bnrm = _norm_tup(b)
    if bnrm == 0.0:
        return b, 0

    x = x0
    r = tuple(bb - aa for bb, aa in zip(b, amatvec(x)))
    rhat = r
    rho = alpha = omega = _one(b)
    v = p = tuple(torch.zeros_like(c) for c in b)

    atol = max(1e-30, var.tol * bnrm)

    for it in range(var.ssl_maxit):
        rho_new = _dot(rhat, r)
        if rho_new == 0:
            return x, -10
        if it > 0:
            beta = (rho_new / rho) * (alpha / omega)
            p = _axpy(r, beta, _axpy(p, -omega, v))
        else:
            p = r
        rho = rho_new

        phat = precond(p) if precond else p
        v = amatvec(phat)
        denom = _dot(rhat, v)
        if denom == 0:
            return x, -11
        alpha = rho / denom
        s = _axpy(r, -alpha, v)

        if _norm_tup(s) < atol:
            x = _axpy(x, alpha, phat)
            var.l2 = _norm_tup(s)
            callback()
            return x, 0

        shat = precond(s) if precond else s
        t = amatvec(shat)
        tt = _dot(t, t)
        if tt == 0:
            return x, -12
        omega = _dot(t, s) / tt

        x = _axpy(_axpy(x, alpha, phat), omega, shat)
        r = _axpy(s, -omega, t)

        var.l2 = _norm_tup(r)
        callback()

        if var.l2 < atol:
            return x, 0
        if omega == 0:
            return x, -13

    return x, var.ssl_maxit


def _cgs(amatvec, precond, b, x0, var, callback):
    """Preconditioned CGS with device-side vectors.

    Conjugate Gradient Squared (Sonneveld), right-preconditioned; fills
    the role of scipy.sparse.linalg.cgs in the reference
    (solver.py:759-765).  Returns (x, info) with the scipy info
    convention.
    """
    bnrm = _norm_tup(b)
    if bnrm == 0.0:
        return b, 0

    x = x0
    r = tuple(bb - aa for bb, aa in zip(b, amatvec(x)))
    rhat = r
    rho = _one(b)
    u = q = p = tuple(torch.zeros_like(c) for c in b)

    atol = max(1e-30, var.tol * bnrm)

    for it in range(var.ssl_maxit):
        rho_new = _dot(rhat, r)
        if rho_new == 0:
            return x, -10
        if it > 0:
            beta = rho_new / rho
            u = _axpy(r, beta, q)
            p = _axpy(u, beta, _axpy(q, beta, p))
        else:
            u = p = r
        rho = rho_new

        phat = precond(p) if precond else p
        v = amatvec(phat)
        denom = _dot(rhat, v)
        if denom == 0:
            return x, -11
        alpha = rho / denom
        q = _axpy(u, -alpha, v)

        uq = tuple(a + c for a, c in zip(u, q))
        uqhat = precond(uq) if precond else uq
        x = _axpy(x, alpha, uqhat)
        r = _axpy(r, -alpha, amatvec(uqhat))

        var.l2 = _norm_tup(r)
        callback()
        if var.l2 < atol:
            return x, 0

    return x, var.ssl_maxit


def _gcrotmk(amatvec, precond, b, x0, var, callback, m=20, k=None):
    """Preconditioned GCROT(m,k) with device-side vectors.

    Recycled-subspace Krylov method (Hicken & Zingg's GCROT(m,k) with
    oldest-out truncation); fills the role of
    scipy.sparse.linalg.gcrotmk in the reference (solver.py:759-765).
    Each outer iteration runs a flexible GMRES(m) inner loop deflated
    against the recycle space C (A·U = C, Cᴴ C = I), forms one new
    (c, u) pair from the inner solution, applies the 1-D projection to
    x and r, and truncates the space to ``k`` pairs.  The large vectors
    stay on the device; only the Arnoldi scalars and the (≤ m+1) × m
    least-squares problem live on the host.  Returns (x, info) with the
    scipy info convention.
    """
    k = k or m
    hdt = np.complex128 if b[0].is_complex() else np.float64
    bnrm = _norm_tup(b)
    if bnrm == 0.0:
        return b, 0
    atol = max(1e-30, var.tol * bnrm)

    x = x0
    r = tuple(bb - aa for bb, aa in zip(b, amatvec(x)))
    CU = []                          # recycle pairs (c, u), A u = c

    for outer in range(var.ssl_maxit):
        beta = _norm_tup(r)
        if beta < atol:
            var.l2 = beta
            return x, 0

        # Flexible GMRES(m) on r, deflated against span(C).
        V = [tuple(c / beta for c in r)]
        Z = []                                    # preconditioned basis
        H = np.zeros((m + 1, m), dtype=hdt)
        B = np.zeros((max(len(CU), 1), m), dtype=hdt)
        y = None
        j_used = 0
        for j in range(m):
            z = precond(V[j]) if precond else V[j]
            w = amatvec(z)
            Z.append(z)
            for i, (c, _) in enumerate(CU):       # deflate
                B[i, j] = _dot(c, w)
                w = _axpy(w, -B[i, j], c)
            for i in range(j + 1):                # Arnoldi (MGS)
                H[i, j] = _dot(V[i], w)
                w = _axpy(w, -H[i, j], V[i])
            H[j + 1, j] = _norm_tup(w)
            j_used = j + 1
            if abs(H[j + 1, j]) >= 1e-14 * beta:
                V.append(tuple(c / float(np.real(H[j + 1, j])) for c in w))

            # Inner least squares + early exit at tolerance.
            e1 = np.zeros(j_used + 1, dtype=hdt)
            e1[0] = beta
            y, *_ = np.linalg.lstsq(
                H[:j_used + 1, :j_used], e1, rcond=None)
            inner_res = np.linalg.norm(
                e1 - H[:j_used + 1, :j_used] @ y)
            if abs(H[j + 1, j]) < 1e-14 * beta or inner_res < atol:
                break

        # New recycle pair from the inner solution:
        #   u~ = Z y − U (B y)   (so that A u~ = V H̄ y ⊥ C),
        #   c~ = V (H̄ y).
        ut = tuple(torch.zeros_like(c) for c in b)
        for j in range(j_used):
            ut = _axpy(ut, y[j], Z[j])
        if CU:
            By = B[:len(CU), :j_used] @ y
            for i, (_, u) in enumerate(CU):
                ut = _axpy(ut, -By[i], u)
        Hy = H[:j_used + 1, :j_used] @ y
        ct = tuple(torch.zeros_like(c) for c in b)
        for i in range(min(j_used + 1, len(V))):
            ct = _axpy(ct, Hy[i], V[i])

        cnrm = _norm_tup(ct)
        if cnrm == 0.0:
            return x, -11
        c_new = tuple(c / cnrm for c in ct)
        u_new = tuple(c / cnrm for c in ut)

        alpha = _dot(c_new, r)
        x = _axpy(x, alpha, u_new)
        r = _axpy(r, -alpha, c_new)

        CU.append((c_new, u_new))
        if len(CU) > k:
            CU.pop(0)

        var.l2 = _norm_tup(r)
        callback()
        if var.l2 < atol:
            return x, 0

    return x, var.ssl_maxit


# ==========================================================================
# Reference-parity functional API (Field-level wrappers).
# ==========================================================================

def _dev_dtypes(model, device):
    """(device, working (field, real) dtypes) of a functional call."""
    device = config.resolve_device(device)
    return device, config.working_dtypes(device, np.iscomplexobj(
        model.eta_x))


def smoothing(model, sfield, efield, nu, lr_dir, device=None):
    """Apply nu Gauss-Seidel steps (in place on efield).

    Reference: solver.py:788-846.  Runs on ``device`` (default: the
    card) in its working precision.
    """
    device, dtypes = _dev_dtypes(model, device)
    ops = _level_tensors(model.eta_x, model.eta_y, model.eta_z, model.zeta,
                         model.grid.h, device, dtypes)
    c_lr_dir = _current_lr_dir(lr_dir, model.grid.shape_cells)
    e = _field_to_dev(efield, device, dtypes[0])
    s = _field_to_dev(sfield, device, dtypes[0])
    e = _smooth(e, s, _Level(ops), c_lr_dir, nu)
    out = _dev_to_field(e, efield.grid, efield._frequency,
                        efield.field.dtype)
    efield.field = out.field


def residual(model, sfield, efield, norm=False, device=None):
    """Residual r = s - A e as a Field (or its l2-norm).

    ``model`` is a VolumeModel.  Evaluated in the host precision
    (complex128/float64) on ``device`` (default: the card).  Reference:
    solver.py:1022-1070.
    """
    device = config.resolve_device(device)
    lvl = _level_tensors(model.eta_x, model.eta_y, model.eta_z, model.zeta,
                         model.grid.h, device, _host_dtypes(model))
    r = operator.residual(*_field_to_dev(sfield, device, lvl[0].dtype),
                          *_field_to_dev(efield, device, lvl[0].dtype), *lvl)
    if norm:
        return float(operator.residual_norm(*r))
    return _dev_to_field(r, sfield.grid, sfield._frequency,
                         sfield.field.dtype)


def restriction(model, sfield, res, sc_dir, device=None):
    """Restrict grid, model, and residual (reference solver.py:849-944).

    The model is restricted on the host; the residual on ``device``
    (default: the card) in its working precision.
    """
    device, dtypes = _dev_dtypes(model, device)
    coarsen = _coarsen_flags(sc_dir)

    ch = [np.diff(getattr(model.grid, 'nodes_' + c)[::2]) if coarsen[i]
          else model.grid.h[i] for i, c in enumerate('xyz')]
    cgrid = meshes.BaseMesh(ch, model.grid.origin)

    class _VolumeModel:
        pass

    cmodel = _VolumeModel()
    cmodel.case = model.case
    cmodel.grid = cgrid
    cmodel._eta_x = np.asarray(transfer.restrict_model_parameters(
        np.asarray(model.eta_x), coarsen))
    if model.case in ['HTI', 'triaxial']:
        cmodel._eta_y = np.asarray(transfer.restrict_model_parameters(
            np.asarray(model.eta_y), coarsen))
    else:
        cmodel._eta_y = cmodel._eta_x
    if model.case in ['VTI', 'triaxial']:
        cmodel._eta_z = np.asarray(transfer.restrict_model_parameters(
            np.asarray(model.eta_z), coarsen))
    else:
        cmodel._eta_z = cmodel._eta_x
    cmodel.zeta = np.asarray(transfer.restrict_model_parameters(
        np.asarray(model.zeta), coarsen))
    cmodel.eta_x = cmodel._eta_x
    cmodel.eta_y = cmodel._eta_y
    cmodel.eta_z = cmodel._eta_z

    # Weights.
    rw = []
    for i, c in enumerate('xyz'):
        if coarsen[i]:
            w = transfer.restrict_weights(
                getattr(model.grid, 'nodes_' + c),
                getattr(model.grid, 'cell_centers_' + c),
                model.grid.h[i],
                getattr(cgrid, 'nodes_' + c),
                getattr(cgrid, 'cell_centers_' + c), ch[i])
            rw.append(tuple(torch.from_numpy(x).to(device, dtypes[1])
                            for x in w))
        else:
            rw.append(None)

    r = _field_to_dev(res, device, dtypes[0])
    cs = transfer.restrict(*r, tuple(rw), coarsen)

    csfield = _dev_to_field(cs, cgrid, sfield._frequency,
                            sfield.field.dtype)
    cefield = fields.Field(cgrid, dtype=sfield.field.dtype,
                           frequency=sfield._frequency)

    return cmodel, csfield, cefield


def prolongation(efield, cefield, sc_dir, device=None):
    """Prolong coarse correction onto the fine field (in place).

    Runs on ``device`` (default: the card) in its working precision.
    Reference: solver.py:947-1019.
    """
    device = config.resolve_device(device)
    dtypes = config.working_dtypes(device, np.iscomplexobj(efield.field))
    coarsen = _coarsen_flags(sc_dir)
    grid, cgrid = efield.grid, cefield.grid

    pm = []
    for i, c in enumerate('xyz'):
        if coarsen[i]:
            idx, w = transfer.prolong_meta(
                getattr(cgrid, 'nodes_' + c), getattr(grid, 'nodes_' + c))
            pm.append((torch.from_numpy(idx).to(device),
                       torch.from_numpy(w).to(device, dtypes[1])))
        else:
            pm.append(None)

    e = _field_to_dev(efield, device, dtypes[0])
    ce = _field_to_dev(cefield, device, dtypes[0])
    e = transfer.prolong(*e, *ce, tuple(pm), coarsen)
    out = _dev_to_field(e, grid, efield._frequency, efield.field.dtype)
    efield.field = out.field


class RegularGridProlongator:
    """2-D bilinear prolongation with precomputed weights (host numpy).

    API-parity class (reference solver.py:1385-1478); the solver itself
    uses the separable 1-D metadata in emg3d_tpu_torch.ops.transfer.
    """

    def __init__(self, cx, cy, x, y):
        self.ix, self.wx = transfer.prolong_meta(np.asarray(cx),
                                                 np.asarray(x))
        self.iy, self.wy = transfer.prolong_meta(np.asarray(cy),
                                                 np.asarray(y))
        self.size = x.size * y.size

    def __call__(self, values):
        lo = values[self.ix][:, self.iy]
        v = ((1 - self.wx[:, None]) * (1 - self.wy[None, :]) * lo
             + self.wx[:, None] * (1 - self.wy[None, :])
             * values[self.ix + 1][:, self.iy]
             + (1 - self.wx[:, None]) * self.wy[None, :]
             * values[self.ix][:, self.iy + 1]
             + self.wx[:, None] * self.wy[None, :]
             * values[self.ix + 1][:, self.iy + 1])
        # Fortran-raveled, matching the reference's return convention.
        return v.ravel(order='F')


# ==========================================================================
# Parameter dataclass.
# ==========================================================================

@dataclass
class MGParameters:
    """Multigrid solver settings and runtime state.

    Mirrors ``emg3d_tpu.solver.MGParameters`` (reference
    solver.py:1074-1381): validation of semicoarsening/linerelaxation
    cycles, per-dimension maximum coarsening levels, and the bookkeeping
    used by the drivers; ``device`` and ``dtype`` place the solve.
    """

    verb: int
    sslsolver: Union[str, bool]
    semicoarsening: Union[int, bool]
    linerelaxation: Union[int, bool]
    shape_cells: tuple

    cycle: Union[str, None] = 'F'
    tol: float = 1e-6
    maxit: int = 50
    nu_init: int = 0
    nu_pre: int = 2
    nu_coarse: int = 1
    nu_post: int = 2
    clevel: int = -1
    return_info: bool = False
    log: int = 0
    device: object = None
    dtype: object = None

    def __post_init__(self):
        self.level_all = list()
        self.first_cycle = True
        self.it = 0
        self.ssl_it = 0
        self.l2 = 1.0
        self.l2_refe = 1.0
        self._max_level()

        self.exit_message = ''
        self.log_message = ''
        self.time = utils.Timer()
        self.runtime_at_cycle = np.array([0.])
        self.error_at_cycle = np.array([0.])
        self.do_return = True
        self.device = config.resolve_device(self.device)

        self._semicoarsening()
        self._linerelaxation()
        self._solver_and_cycle()

    def __repr__(self):
        return (
            f"   MG-cycle       : {self.cycle!r:17}"
            f"   sslsolver : {self.sslsolver!r}\n"
            f"   semicoarsening : {self._repr_sc_dir:17}"
            f"   tol       : {self.tol}\n"
            f"   linerelaxation : {self._repr_lr_dir:17}"
            f"   maxit     : {self._repr_maxit}\n"
            f"   nu_{{i,1,c,2}}   : {self.nu_init}, {self.nu_pre},"
            f" {self.nu_coarse}, {self.nu_post}       "
            f"   verb      : {self.verb}\n"
            f"   Original grid  : {self.shape_cells[0]:3} x"
            f" {self.shape_cells[1]:3} x {self.shape_cells[2]:3}\n"
            f"   Device         : {self.device}\n"
        )

    def cprint(self, info, verbosity, **kwargs):
        """Print and log ``info`` if sufficiently verbose."""
        if self.verb > verbosity:
            if self.log != 0:
                self.log_message += str(info) + '\n'
            if self.log >= 0:
                print(info, **kwargs)

    def _max_level(self):
        """Per-dimension max coarsening level (solver.py:1202-1270).

        Each dimension coarsens while its cell count is even and > 2;
        a user-set ``clevel`` >= 0 caps every dimension's depth.  The
        result is the per-sc_dir depth table (index 0: standard
        coarsening; 1-3: the dimension named by sc_dir is excluded).
        """
        if np.any(np.array(self.shape_cells) < 2):
            raise ValueError(
                "Nr. of cells must be at least two in each direction. "
                f"Provided shape: {self.shape_cells}.")
        clevel = np.zeros(3, dtype=np.int64)
        for i in range(3):
            n = self.shape_cells[i]
            while n % 2 == 0 and n > 2:
                clevel[i] += 1
                n /= 2

        if self.clevel >= 0:
            clevel = np.minimum(clevel, self.clevel)

        self.clevel = np.array([
            max(clevel[0], clevel[1], clevel[2]),  # sc_dir=0
            max(clevel[1], clevel[2]),             # sc_dir=1
            max(clevel[0], clevel[2]),             # sc_dir=2
            max(clevel[0], clevel[1]),             # sc_dir=3
        ])

    def _semicoarsening(self):
        """Set up semicoarsening cycling (solver.py:1272-1304)."""
        if self.semicoarsening is True:
            sc_cycle = np.array([1, 2, 3])
            self.sc_cycle = itertools.cycle(sc_cycle)
        elif self.semicoarsening in np.arange(4):
            sc_cycle = np.array([int(self.semicoarsening)])
            self.sc_cycle = False
        else:
            sc_cycle = np.array(
                [int(x) for x in str(abs(int(self.semicoarsening)))])
            self.sc_cycle = itertools.cycle(sc_cycle)
            if np.any(sc_cycle < 0) or np.any(sc_cycle > 3):
                raise ValueError(
                    "`semicoarsening` must be one of {False;True;0;1;2;3} "
                    "or a combination of {0;1;2;3} to cycle. "
                    f"Provided: {self.semicoarsening}.")

        if self.sc_cycle:
            self.sc_dir = next(self.sc_cycle)
        else:
            self.sc_dir = sc_cycle[0]

        self.semicoarsening = self.sc_dir != 0
        self._repr_sc_dir = f"{self.semicoarsening} {sc_cycle}"
        self.raw_sc_cycle = sc_cycle

    def _linerelaxation(self):
        """Set up line-relaxation cycling (solver.py:1306-1339)."""
        if self.linerelaxation is True:
            lr_cycle = np.array([4, 5, 6])
            self.lr_cycle = itertools.cycle(lr_cycle)
        elif self.linerelaxation in np.arange(8):
            lr_cycle = np.array([int(self.linerelaxation)])
            self.lr_cycle = False
        else:
            lr_cycle = np.array(
                [int(x) for x in str(abs(int(self.linerelaxation)))])
            self.lr_cycle = itertools.cycle(lr_cycle)
            if np.any(lr_cycle < 0) or np.any(lr_cycle > 7):
                raise ValueError(
                    "`linerelaxation` must be one of "
                    "{False;True;0;...;7} or a combination of {1;...;7} "
                    f"to cycle. Provided: {self.linerelaxation}.")

        if self.lr_cycle:
            self.lr_dir = next(self.lr_cycle)
        else:
            self.lr_dir = lr_cycle[0]

        self.linerelaxation = self.lr_dir != 0
        self._repr_lr_dir = f"{self.linerelaxation} {lr_cycle}"
        self.raw_lr_cycle = lr_cycle

    def _solver_and_cycle(self):
        """Validate solver/cycle combination (solver.py:1341-1381)."""
        solvers = ['bicgstab', 'cgs', 'gcrotmk']
        if self.sslsolver is True:
            self.sslsolver = 'bicgstab'
        elif self.sslsolver is not False and self.sslsolver not in solvers:
            raise ValueError(
                f"`sslsolver` must be True, False, or one of {solvers}. "
                f"Provided: {self.sslsolver!r}.")

        if self.cycle not in ['F', 'V', 'W', None]:
            raise ValueError(
                "`cycle` must be one of {'F';'V';'W';None}. "
                f"Provided: {self.cycle}.")

        if self.cycle in ['F', 'W']:
            self.cycmax = 2
        else:
            self.cycmax = 1

        if not self.sslsolver and not self.cycle:
            raise ValueError(
                "At least `cycle` or `sslsolver` is required. Provided "
                f"input: cycle={self.cycle}; sslsolver={self.sslsolver}.")

        self.ssl_maxit = 0
        self._repr_maxit = f"{self.maxit}"
        self.maxcycle = max(len(self.raw_sc_cycle), len(self.raw_lr_cycle))
        if self.sslsolver:
            self.ssl_maxit = self.maxit
            if self.cycle is not None:
                self.maxit = self.maxcycle
                self._repr_maxit += f" ({self.maxit})"
