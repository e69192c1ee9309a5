"""Multigrid solver for 3-D electromagnetic diffusion (PyTorch).

Port of the main path of ``emg3d_tpu.solver``: stand-alone multigrid
(``plain=True``; V, W or F cycles) with the 8-color point Gauss-Seidel
smoother and full coarsening, on one device.

- The hierarchy (coarse grids, restricted model, transfer weights) is
  built once per solve on the host and placed on ``device`` as one
  :class:`_Level` per grid.
- The cycle is host-driven and eager: smoothing phases (the ``gs_phase``
  kernel on CUDA), residual + restriction, recursion, prolongation.
- The iterate is accumulated as an unevaluated sum ``e_hi + e_lo`` with
  an error-free two-sum, and the residual that decides convergence is
  evaluated in native complex128/float64, so a complex64 solve reaches
  tolerances below float32 resolution.

Not ported yet (they raise ``NotImplementedError``): the MG-preconditioned
Krylov solvers, semicoarsening and line relaxation.
"""

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import scipy as sp
import torch

from emg3d_tpu_torch import config, fields, meshes, models, utils
from emg3d_tpu_torch.ops import operator, smoothers, transfer

__all__ = ['solve', 'solve_source', 'multigrid', 'residual', 'MGParameters']

_ROADMAP = ("not ported to emg3d_tpu_torch yet (ROADMAP.md, 'Modules to "
            "port': semicoarsening, line relaxation and krylov); use "
            "plain=True")


# ==========================================================================
# Public entry points.
# ==========================================================================

def solve(model, sfield, sslsolver=True, semicoarsening=True,
          linerelaxation=True, verb=0, **kwargs):
    """Solve the 3-D electromagnetic diffusion equation.

    Same signature and semantics as ``emg3d_tpu.solver.solve`` (reference
    emg3d/solver.py:52-449), restricted to stand-alone multigrid:
    ``plain=True`` (or ``sslsolver``, ``semicoarsening`` and
    ``linerelaxation`` all off).  Two more keywords:

    - ``device``: where the solve runs (default CPU); every hierarchy
      tensor is placed there.  CUDA on a host without a card raises.
    - ``dtype``: device working dtype (default complex64/float32 on CUDA,
      complex128/float64 on the CPU).

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
            var.cycle = None
            var.exit_message = "CONVERGED"
            info = "   > NOTHING DONE (provided efield already good enough)\n"

    # Zero source -> zero field.
    if var.l2_refe < 100 * np.finfo(np.float64).tiny:
        var.l2_refe = np.nan
        var.cycle = None
        var.exit_message = "CONVERGED"
        info = "   > RETURN ZERO E-FIELD (provided sfield is zero)\n"
        efield = fields.Field(model.grid, dtype=sfield.field.dtype,
                              frequency=sfield._frequency)

    if var.cycle:
        multigrid(vmodel, sfield, efield, var)

    exit_status = int(var.exit_message != 'CONVERGED')

    if var.verb > 2:
        if var.cycle:
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


def residual(model, sfield, efield, norm=False, device=None):
    """Residual r = s - A e as a Field (or its l2-norm).

    ``model`` is a VolumeModel.  Evaluated in the host precision
    (complex128/float64) on ``device``.  Reference: solver.py:1022-1070.
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
# Hierarchy construction.
# ==========================================================================

@dataclass
class _Level:
    """Tensors and metadata of one multigrid level on the device.

    ``ops`` are (eta_x, eta_y, eta_z, zeta, hx, hy, hz) in working
    precision.  ``coarsen``, ``rw`` (per-axis restriction weights) and
    ``pm`` (per-axis prolongation (idx, w)) describe the transfer to the
    next coarser level; they are None on the coarsest.  ``ops64`` (level
    0 only) holds the operator in complex128/float64 for the residual
    that decides convergence.
    """

    ops: tuple
    coarsen: Optional[tuple] = None
    rw: Optional[tuple] = None
    pm: Optional[tuple] = None
    ops64: Optional[tuple] = None


def _coarsen_flags(shape):
    """(bool, bool, bool): which axes get coarsened.

    Full coarsening, except that an axis whose cell count is odd or
    below 3 stays as it is (reference solver.py:1482-1531 with
    sc_dir=0 and solver.py:891-897).
    """
    return tuple(n % 2 == 0 and n >= 3 for n in shape)


def _build_hierarchy(vmodel, clevel_max, device, dtypes):
    """Build the per-level device tensors, finest level first.

    Model restriction is the 2/4/8-cell sum of the reference
    (solver.py:1667-1718), on the host in float64/complex128; weights
    per Muld06 Eq. 9.
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

    levels = []
    for level in range(clevel_max + 1):
        grid = meshes.BaseMesh(h, origin)
        shape = grid.shape_cells
        lvl = _Level(_level_tensors(eta_x, eta_y, eta_z, zeta, h, device,
                                    dtypes))
        if level == 0:
            host = _host_dtypes(vmodel)
            lvl.ops64 = (lvl.ops if host == dtypes else _level_tensors(
                eta_x, eta_y, eta_z, zeta, h, device, host))
        levels.append(lvl)
        if level == clevel_max:
            break

        # Coarsen for the next level.
        coarsen = _coarsen_flags(shape)
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
        lvl.coarsen, lvl.rw, lvl.pm = coarsen, tuple(rw), tuple(pm)

        # Restrict model parameters (host numpy).
        eta_x = transfer.restrict_model_parameters(eta_x, coarsen)
        eta_y = transfer.restrict_model_parameters(eta_y, coarsen)
        eta_z = transfer.restrict_model_parameters(eta_z, coarsen)
        zeta = transfer.restrict_model_parameters(zeta, coarsen)
        h = ch

    return levels


# ==========================================================================
# Level operations.
# ==========================================================================

def _smooth(e, s, lvl, nu):
    """``nu`` point Gauss-Seidel sweeps on level ``lvl``, in place on e."""
    return smoothers.gauss_seidel(*e, *s, *lvl.ops, nu)


def _restrict(e, s, lvl):
    """Residual + restriction -> (coarse source, zero coarse guess)."""
    res = operator.residual(*s, *e, *lvl.ops)
    cs = transfer.restrict(*res, lvl.rw, lvl.coarsen)
    return cs, tuple(torch.zeros_like(c) for c in cs)


def _prolong(e, ce, lvl):
    """Add the prolonged coarse correction to e, in place."""
    return transfer.prolong(*e, *ce, lvl.pm, lvl.coarsen)


def _residual_norm_split(e_hi, e_lo, s, lvl):
    """Residual r = s - A (e_hi + e_lo) and its norm, in double precision.

    The split iterate and the source are promoted to complex128/float64
    and the residual is evaluated with the level-0 operator in that
    precision (``_residual_norm_split_f64_jit`` of the JAX package; no
    double-single arithmetic is needed on hardware with FP64).  Returns
    the residual in working precision and the norm as a float.
    """
    ops64 = lvl.ops64
    up = ops64[0].dtype
    e = tuple(h.to(up) + l.to(up) for h, l in zip(e_hi, e_lo))
    r = operator.residual(*(c.to(up) for c in s), *e, *ops64)
    l2 = float(operator.residual_norm(*r))
    return tuple(c.to(e_hi[0].dtype) for c in r), l2


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


def _cycle_correction(levels, r, var, first):
    """One multigrid cycle applied to residual ``r`` from a zero guess.

    The cycle is a linear stationary iteration, so running it on (A, r)
    from zero and adding the result to the iterate equals the
    reference's in-place form (solver.py:471-649), while letting the
    caller accumulate in split precision.  Includes the F-cycle's
    decreasing-cycmax mechanics (reference solver.py:519-526) and the
    coarsest-grid Gauss-Seidel solve (solver.py:566-578).  Returns the
    correction ``de``.
    """
    nlevels = len(levels)
    cycle = var.cycle
    cycmax0 = var.cycmax

    def track_smooth(e, s, level, nu):
        # The level trace feeds the verb>3 cycle-QC visualization.
        var.level_all.append(level)
        return _smooth(e, s, levels[level], nu)

    def recurse(s, e, level, new_cycmax):
        lvl = levels[level]
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
                cs, ce = _restrict(e, s, lvl)
                ce = recurse(cs, ce, level + 1, cycmax - cyc)
                e = _prolong(e, ce, lvl)
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
        cs, ce = _restrict(de, r, levels[0])
        ce = recurse(cs, ce, 1, cycmax0)
        de = _prolong(de, ce, levels[0])
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


# ==========================================================================
# Host-driven multigrid.
# ==========================================================================

def multigrid(model, sfield, efield, var):
    """Run multigrid cycles until a termination criterion fires.

    Host-driven outer loop; mirrors the level-0 loop of reference
    solver.py:471-649.  ``model`` is a VolumeModel; ``sfield``/``efield``
    are Fields (efield is updated in place).
    """
    dtypes = config.working_dtypes(
        var.device, np.iscomplexobj(sfield.field), var.dtype)
    levels = _build_hierarchy(model, var.clevel, var.device, dtypes)

    s = _field_to_dev(sfield, var.device, dtypes[0])
    e_hi = _field_to_dev(efield, var.device, dtypes[0])
    e_lo = tuple(torch.zeros_like(c) for c in e_hi)

    r, l2_last = _residual_norm_split(e_hi, e_lo, s, levels[0])
    l2_stag = np.ones(var.maxcycle) * l2_last

    it = 0
    first = True
    while True:
        l2_prev = l2_last
        l2_stag[(it - 1) % var.maxcycle] = l2_last

        de = _cycle_correction(levels, r, var, first)
        _accumulate_(e_hi, e_lo, de)
        r, l2_last = _residual_norm_split(e_hi, e_lo, s, levels[0])

        if var.first_cycle:
            var.first_cycle = False
            if var.verb > 3:
                var.cprint(_cycle_qc(var), 3)
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

    if l2_last < var.tol * var.l2_refe:
        var.exit_message = "CONVERGED"
        finished = True
    elif l2_last > 10 * var.l2_refe or not np.isfinite(l2_last):
        var.exit_message = "DIVERGED"
        finished = True
    elif it > 2 and l2_last >= l2_stag:
        var.exit_message = "STAGNATED"
        finished = True
    elif it == var.maxit:
        var.exit_message = "MAX. ITERATION REACHED, NOT CONVERGED"
        finished = True

    if finished:
        var.cprint("   > " + var.exit_message, 2)

    return finished


# ==========================================================================
# Parameter dataclass.
# ==========================================================================

@dataclass
class MGParameters:
    """Multigrid solver settings and runtime state.

    Mirrors ``emg3d_tpu.solver.MGParameters`` (reference
    solver.py:1074-1381) for stand-alone multigrid with full coarsening
    and the point smoother; ``device`` and ``dtype`` place the solve.
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

        self._off('semicoarsening', self.semicoarsening)
        self._off('linerelaxation', self.linerelaxation)
        self.sc_dir = 0
        self.lr_dir = 0
        self.semicoarsening = False
        self.linerelaxation = False
        self._solver_and_cycle()

    def __repr__(self):
        return (
            f"   MG-cycle       : {self.cycle!r:17}"
            f"   sslsolver : {self.sslsolver!r}\n"
            f"   semicoarsening : {'False [0]':17}"
            f"   tol       : {self.tol}\n"
            f"   linerelaxation : {'False [0]':17}"
            f"   maxit     : {self.maxit}\n"
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
        """Maximum coarsening level (solver.py:1202-1270).

        Each dimension coarsens while its cell count is even and > 2;
        a user-set ``clevel`` >= 0 caps every dimension's depth.  With
        full coarsening the hierarchy is as deep as the deepest
        dimension (the other dimensions stop coarsening earlier).
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
        self.clevel = int(clevel.max())

    @staticmethod
    def _off(name, value):
        """Raise unless the option ``name`` is off (False or 0)."""
        if value is not False and value != 0:
            raise NotImplementedError(f"`{name}={value!r}` is {_ROADMAP}.")

    def _solver_and_cycle(self):
        """Validate solver/cycle combination (solver.py:1341-1381)."""
        solvers = ['bicgstab', 'cgs', 'gcrotmk']
        if self.sslsolver is True or self.sslsolver in solvers:
            raise NotImplementedError(
                f"`sslsolver={self.sslsolver!r}` is {_ROADMAP}.")
        if self.sslsolver is not False:
            raise ValueError(
                f"`sslsolver` must be True, False, or one of {solvers}. "
                f"Provided: {self.sslsolver!r}.")

        if self.cycle not in ['F', 'V', 'W']:
            raise ValueError(
                "`cycle` must be one of {'F';'V';'W'} without an "
                f"sslsolver. Provided: {self.cycle}.")

        self.cycmax = 2 if self.cycle in ['F', 'W'] else 1
        # Length of the stagnation ring: one entry without cycling of
        # semicoarsening/line-relaxation directions.
        self.maxcycle = 1
