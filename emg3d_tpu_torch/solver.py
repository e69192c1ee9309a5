"""Multigrid solver for 3-D electromagnetic diffusion (PyTorch).

Port of ``emg3d_tpu.solver``: MG-preconditioned Krylov solvers
(BiCGSTAB, CGS, GCROT(m,k)) and stand-alone multigrid (V, W or F cycles),
with semicoarsening and line relaxation (by default BiCGSTAB,
semicoarsening cycling over [1, 2, 3] and line relaxation over [4, 5, 6]),
on one device or, with ``mesh=``, on a grid sharded over several
(:mod:`emg3d_tpu_torch.parallel.domain`).

- The hierarchies (coarse grids, restricted model, transfer weights) are
  built on the host per semicoarsening direction and placed on
  ``device`` as one :class:`_Level` per grid; the line-relaxation
  direction only changes the per-level smoother flags
  (:class:`_Hierarchies`).
- The cycle is host-driven: smoothing phases (the ``gs_phase`` and
  ``line_phase`` kernels on CUDA), residual + restriction, recursion,
  prolongation.  On the card each cycle, its accumulate and the next
  residual norm run as one replay of a captured CUDA graph
  (``EMG3D_TPU_CYCLE_JIT``, see :func:`_use_cycle_graph`); elsewhere, or
  with the switch off, operation by operation.
- Multigrid accumulates its iterate as an unevaluated sum ``e_hi + e_lo``
  with an error-free two-sum, and the residual that decides convergence
  is evaluated in native complex128/float64, so a complex64 solve reaches
  tolerances below float32 resolution.
- The Krylov vectors live in complex128/float64 on the device; only the
  multigrid preconditioner runs in the working precision.
"""

import collections
import itertools
import os
import weakref
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import scipy as sp
import torch

from emg3d_tpu_torch import config, fields, meshes, models, tracing, utils
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
    stand-alone multigrid F-cycles.  Three more keywords:

    - ``device``: where the solve runs.  The default (None) is the CUDA
      card; without a card it raises ``RuntimeError``.  Pass
      ``device='cpu'`` to run on the CPU.  Every hierarchy tensor is
      placed there.
    - ``dtype``: device working dtype of the multigrid (default
      complex64/float32 on CUDA, complex128/float64 on the CPU).
    - ``mesh``: a ``parallel.domain.DeviceGrid`` (``make_grid_mesh``) or
      ``GridPlacement`` shards the grid over its devices, as
      ``emg3d_tpu.solver.solve(mesh=...)`` does; ``device`` is then the
      mesh's first device (the default), where replicated levels and the
      whole fields live.  The cycles run operation by operation.

    Returns the electric field (and an info dict if ``return_info``).
    The call is the root span ``emg3d.solve`` (:mod:`tracing`).
    """
    with tracing.span('emg3d.solve', shape=tuple(model.shape)):
        return _solve(model, sfield, sslsolver, semicoarsening,
                      linerelaxation, verb, **kwargs)


def _solve(model, sfield, sslsolver, semicoarsening, linerelaxation, verb,
           **kwargs):
    always_return = kwargs.pop('always_return', False)

    if kwargs.pop('plain', False):
        sslsolver = False if sslsolver is True else sslsolver
        semicoarsening = False if semicoarsening is True else semicoarsening
        linerelaxation = False if linerelaxation is True else linerelaxation
    efield = kwargs.pop('efield', None)

    # Domain decomposition: a DeviceGrid (or a GridPlacement) shards the
    # grid over devices; see emg3d_tpu_torch.parallel.domain.
    mesh = kwargs.pop('mesh', None)
    placement = None
    if mesh is not None:
        from emg3d_tpu_torch.parallel.domain import (GridPlacement,
                                                     device_list)
        placement = (mesh if isinstance(mesh, GridPlacement)
                     else GridPlacement(mesh))
        device = kwargs.get('device')
        if device is not None and (device_list(devices=[device])[0]
                                   != placement.device):
            raise ValueError(
                f"device={device}, but the mesh's first device is "
                f"{placement.device}.")
        kwargs['device'] = placement.device

    var = MGParameters(
        sslsolver=sslsolver, semicoarsening=semicoarsening,
        linerelaxation=linerelaxation, shape_cells=model.shape, verb=verb,
        **kwargs)
    var.placement = placement

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

def _to_device(a, device, dtype=None):
    """A host array (or host tensor) as a C-contiguous tensor of ``dtype``
    on ``device``; counts ``h2d_bytes`` (of the device tensor) and
    ``h2d_copies``."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    t = a.to(device=device, dtype=dtype)
    tracing.count('h2d_bytes', t.numel() * t.element_size())
    tracing.count('h2d_copies')
    return t


def _to_host(t):
    """A device tensor (or the Pieces of a sharded one) as a host NumPy
    array; counts ``d2h_bytes`` and ``d2h_copies``."""
    h = t.cpu()
    tracing.count('d2h_bytes', h.numel() * h.element_size())
    tracing.count('d2h_copies')
    return h.numpy()


def _scalar(t):
    """A host read of device values, in an ``emg3d.sync`` span; counts
    ``host_syncs``.  A 0-d tensor gives a float (a complex for a complex
    tensor), any other a NumPy array."""
    with tracing.span('emg3d.sync'):
        tracing.count('host_syncs')
        a = _to_host(t)
    return a.item() if a.ndim == 0 else a


def _field_to_dev(field, device, dtype):
    """Field -> tuple of C-contiguous device tensors of ``dtype``.

    The Field's components are Fortran-ordered views: they are made
    C-contiguous before the copy.
    """
    return tuple(_to_device(f, device, dtype)
                 for f in (field.fx, field.fy, field.fz))


def _dev_to_field(e, grid, frequency, dtype):
    """Tuple of device tensors -> Field (host), in an
    ``emg3d.fields.to_host`` span."""
    with tracing.span('emg3d.fields.to_host'):
        out = fields.Field(grid, dtype=dtype, frequency=frequency)
        out.fx = _to_host(e[0]).astype(dtype)
        out.fy = _to_host(e[1]).astype(dtype)
        out.fz = _to_host(e[2]).astype(dtype)
    return out


def _host_dtypes(vmodel):
    """(field dtype, real dtype) of the host precision for ``vmodel``."""
    if np.iscomplexobj(vmodel.eta_x):
        return torch.complex128, torch.float64
    return torch.float64, torch.float64


def _level_tensors(eta_x, eta_y, eta_z, zeta, h, device, dtypes):
    """(eta_x, eta_y, eta_z, zeta, hx, hy, hz) as device tensors."""
    cdt, rdt = dtypes
    return (*(_to_device(a, device, cdt) for a in (eta_x, eta_y, eta_z)),
            *(_to_device(a, device, rdt) for a in (zeta, *h)))


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

    # A level of a grid-sharded solve is a ``parallel.domain.ShardedLevel``
    # (``sharded`` True), whose methods the level operations call.
    sharded = False


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


def _build_hierarchy(vmodel, sc_dir, lr_dir, clevel_max, device, dtypes,
                     placement=None):
    """Build the per-level device tensors for one sc_dir, finest first.

    Returns ``(meta, levels)``: ``meta`` holds per level the static
    ``(shape, c_lr_dir, coarsen)`` (``coarsen`` is None on the coarsest),
    ``levels`` the :class:`_Level` tensors.  Model restriction is the
    2/4/8-cell sum of the reference (solver.py:1667-1718), on the host in
    float64/complex128; weights per Muld06 Eq. 9.

    ``placement`` (a ``parallel.domain.GridPlacement``) shards the fine
    levels over its mesh (``domain.ShardedLevel``), as long as its plan
    keeps them sharded; the coarser ones are built on ``device``.
    """
    rdt = dtypes[1]
    eta_x = np.asarray(vmodel.eta_x)
    eta_y = np.asarray(vmodel.eta_y)
    eta_z = np.asarray(vmodel.eta_z)
    zeta = np.asarray(vmodel.zeta)
    h = [np.asarray(vmodel.grid.h[i]) for i in range(3)]
    origin = np.asarray(vmodel.grid.origin)

    meta, levels = [], []
    layout = (None if placement is None
              else placement.layout(vmodel.grid.shape_cells))
    for level in range(clevel_max + 1):
        grid = meshes.BaseMesh(h, origin)
        shape = tuple(grid.shape_cells)
        host = _host_dtypes(vmodel) if level == 0 else None
        if layout is not None:
            lvl = placement.level(layout, (eta_x, eta_y, eta_z, zeta), h,
                                  dtypes, host)
        else:
            with tracing.span('emg3d.hierarchy.to_device'):
                lvl = _Level(_level_tensors(eta_x, eta_y, eta_z, zeta, h,
                                            device, dtypes))
                if level == 0:
                    lvl.ops64 = (lvl.ops if host == dtypes else
                                 _level_tensors(eta_x, eta_y, eta_z, zeta,
                                                h, device, host))
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
                rw.append(transfer.restrict_weights(
                    nodes, getattr(grid, 'cell_centers_' + coord), h[i],
                    cnodes, getattr(cgrid, 'cell_centers_' + coord), ch[i]))
                pm.append(transfer.prolong_meta(cnodes, nodes))
            else:
                rw.append(None)
                pm.append(None)
        if layout is not None:
            lvl.set_transfer(coarsen, tuple(cgrid.shape_cells), rw, pm)
            layout = lvl.coarse[0] if lvl.coarse[1] else None
        else:
            with tracing.span('emg3d.hierarchy.to_device'):
                lvl.rw = tuple(
                    None if w is None else tuple(
                        _to_device(x, device, rdt) for x in w)
                    for w in rw)
                lvl.pm = tuple(
                    None if m is None else (_to_device(m[0], device),
                                            _to_device(m[1], device, rdt))
                    for m in pm)

        # Restrict model parameters (host numpy).
        with tracing.span('emg3d.hierarchy.restrict_model'):
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
    the line-relaxation cycling values (e.g. '456').  The levels are
    built on ``device`` (default ``var.device``), the fine ones sharded
    where ``var.placement`` says so.
    """

    def __init__(self, vmodel, var, device=None):
        self.vmodel = vmodel
        self.var = var
        self.device = var.device if device is None else device
        self.dtypes = config.working_dtypes(
            self.device, np.iscomplexobj(vmodel.eta_x), var.dtype)
        self.placement = var.placement
        self.layout = (None if self.placement is None
                       else self.placement.layout(vmodel.grid.shape_cells))
        self._cache = {}
        self._acache = {}

    def to_dev(self, field, dtype):
        """A host Field on the finest level: device tensors, or Pieces of
        its layout where it is sharded."""
        with tracing.span('emg3d.fields.to_device'):
            if self.layout is None:
                return _field_to_dev(field, self.device, dtype)
            from emg3d_tpu_torch.parallel import domain
            return domain.place_field(self.layout, (field.fx, field.fy,
                                                    field.fz), dtype)

    def get(self, sc_dir, lr_dir):
        key = (int(sc_dir), int(lr_dir))
        if key not in self._cache:
            akey = int(sc_dir)
            if akey not in self._acache:
                with tracing.span('emg3d.hierarchy.build', sc_dir=akey):
                    tracing.count('hierarchy_builds')
                    self._acache[akey] = self._build(
                        sc_dir, lr_dir, self.var.clevel[min(akey, 3)])
            meta0, levels = self._acache[akey]
            meta = tuple((shape, _current_lr_dir(lr_dir, shape), coarsen)
                         for shape, _, coarsen in meta0)
            self._cache[key] = (meta, levels)
        return self._cache[key]

    def _build(self, sc_dir, lr_dir, clevel_max):
        return _build_hierarchy(self.vmodel, sc_dir, lr_dir, clevel_max,
                                self.device, self.dtypes, self.placement)


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
        e = _relax(e, s, lvl, nu)
    for axis, dirs in LINE_AXES:
        if c_lr_dir in dirs:
            e = _relax(e, s, lvl, nu, axis)
    return e


def _relax(e, s, lvl, nu, axis=None):
    """``nu`` sweeps of the point smoother (``axis`` None) or of the line
    smoother along ``axis``, in place on e."""
    if lvl.sharded:
        return lvl.relax(e, s, nu, axis)
    if axis is None:
        return smoothers.gauss_seidel(*e, *s, *lvl.ops, nu, lvl.scale)
    return smoothers.gauss_seidel_line(*e, *s, *lvl.ops, nu, axis,
                                       lvl.scale)


def _scaled(ops, scale):
    """``ops`` with every task's eta: ``scale[k] * eta`` for a shared eta
    with a per-task scale; unchanged without a scale."""
    if scale is None:
        return ops
    sc = scale[:, None, None, None]
    return (*(sc * c for c in ops[:3]), *ops[3:])


def _restrict(e, s, lvl, coarsen):
    """Residual + restriction -> (coarse source, zero coarse guess)."""
    if lvl.sharded:
        return lvl.restrict(e, s, coarsen)
    res = operator.residual(*s, *e, *_scaled(lvl.ops, lvl.scale))
    cs = transfer.restrict(*res, lvl.rw, coarsen)
    return cs, tuple(torch.zeros_like(c) for c in cs)


def _prolong(e, ce, lvl, coarsen):
    """Add the prolonged coarse correction to e, in place."""
    if lvl.sharded:
        return lvl.prolong(e, ce, coarsen)
    return transfer.prolong(*e, *ce, lvl.pm, coarsen)


def _residual_norm_split(e_hi, e_lo, s, lvl, per_task=False):
    """Residual r = s - A (e_hi + e_lo) and its norm, in double precision.

    The split iterate and the source are promoted to complex128/float64
    and the residual is evaluated with the level-0 operator in that
    precision (``_residual_norm_split_f64_jit`` of the JAX package; no
    double-single arithmetic is needed on hardware with FP64), a shared
    eta scaled by ``scale64``.  Returns the residual in working precision
    and the norm as a 0-d device tensor, or with ``per_task`` the norms
    of a task axis as a (B,) device tensor.
    """
    if lvl.sharded and not per_task:
        return lvl.residual_norm_split(e_hi, e_lo, s)
    ops64 = _scaled(lvl.ops64, lvl.scale64)
    up = ops64[0].dtype
    e = tuple(h.to(up) + l.to(up) for h, l in zip(e_hi, e_lo))
    r = operator.residual(*(c.to(up) for c in s), *e, *ops64)
    l2 = operator.residual_norm(*r, per_task=per_task)
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


def _smooth_traced(e, s, meta, levels, level, nu, var):
    """``_smooth`` on ``level``, its index appended to ``var.level_all``
    (the level trace that feeds the verb>3 cycle-QC visualization)."""
    var.level_all.append(level)
    return _smooth(e, s, levels[level], meta[level][1], nu)


def _cycle_level(s, e, meta, levels, level, new_cycmax, var):
    """The cycle on ``level`` (> 0) and below, in place on its guess e.

    ``new_cycmax`` is the F-cycle's decreasing cycle count handed down by
    the level above (reference solver.py:519-526); the coarsest level
    runs one Gauss-Seidel solve (solver.py:566-578).  A module function
    that calls itself by name: a nested closure that called itself would
    hold its own cell, a reference cycle that kept the whole hierarchy
    alive until the collector ran.
    """
    coarsest = level == len(meta) - 1
    if coarsest:
        cycmax = 1
    elif new_cycmax == 0 or var.cycle != 'F':
        cycmax = var.cycmax
    else:
        cycmax = new_cycmax

    for cyc in range(cycmax):
        if coarsest:
            e = _smooth_traced(e, s, meta, levels, level, var.nu_coarse,
                               var)
            continue
        if var.nu_pre > 0:
            e = _smooth_traced(e, s, meta, levels, level, var.nu_pre, var)
        cs, ce = _restrict(e, s, levels[level], meta[level][2])
        ce = _cycle_level(cs, ce, meta, levels, level + 1, cycmax - cyc,
                          var)
        e = _prolong(e, ce, levels[level], meta[level][2])
        if var.nu_post > 0:
            e = _smooth_traced(e, s, meta, levels, level, var.nu_post, var)
    return e


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
    de = tuple(torch.zeros_like(c) for c in r)

    if first and var.nu_init > 0:
        de = _smooth_traced(de, r, meta, levels, 0, var.nu_init, var)

    if len(meta) == 1:
        de = _smooth_traced(de, r, meta, levels, 0, var.nu_coarse, var)
    else:
        if var.nu_pre > 0:
            de = _smooth_traced(de, r, meta, levels, 0, var.nu_pre, var)
        cs, ce = _restrict(de, r, levels[0], meta[0][2])
        ce = _cycle_level(cs, ce, meta, levels, 1, var.cycmax, var)
        de = _prolong(de, ce, levels[0], meta[0][2])
        if var.nu_post > 0:
            de = _smooth_traced(de, r, meta, levels, 0, var.nu_post, var)

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
# Whole-cycle steps (EMG3D_TPU_CYCLE_JIT): one CUDA graph per cycle.
#
# The host-driven cycle launches thousands of small kernels per multigrid
# cycle, and the card idles while the host launches them.  A step runs one
# cycle, its split-precision accumulate and the next residual norm as one
# replay of a captured CUDA graph, with one host sync per cycle (the
# norm): the counterpart of the JAX package's whole-cycle executables
# (``_whole_step_factory``, ``_whole_corr_factory``).  As there, the
# level tensors are not part of the key: a step reads static copies of
# them (``_LevelStore``) into which each solve's hierarchy is copied, so
# every solve on a grid of one configuration replays the same graphs.
# ==========================================================================

# Captures and replays of whole-cycle steps since the last reset_counts().
# On the CPU, where nothing is captured, they count what the card would
# capture and replay.
CYCLE_CAPTURES = 0
CYCLE_REPLAYS = 0

# Bound of the step cache: the steps of four grid configurations of the
# default solver (three (sc_dir, lr_dir) pairs, each a step and a
# correction step).  The least recently used step is dropped beyond it.
_MAX_STEPS = 24
_STEPS = collections.OrderedDict()

# The states and level stores the cached steps share, while any step
# holds them.
_STATES = weakref.WeakValueDictionary()
_STORES = weakref.WeakValueDictionary()

# One memory pool for every capture.  Sharing it is safe here: replays
# run one at a time on one stream, each graph's allocations are
# temporaries of its own replay, and every output of a step lives in
# buffers the step holds (allocated outside any capture).
_POOL = None


def reset_counts():
    """Set ``CYCLE_CAPTURES`` and ``CYCLE_REPLAYS`` to 0."""
    global CYCLE_CAPTURES, CYCLE_REPLAYS
    CYCLE_CAPTURES = 0
    CYCLE_REPLAYS = 0


def _use_cycle_graph(var):
    """Whether a solve runs its cycles as whole-cycle steps.

    Reads ``EMG3D_TPU_CYCLE_JIT`` (``1`` | ``0`` | ``auto``, default
    ``auto``) on every solve, as ``_use_cycle_jit`` of the JAX package
    does: ``1`` on any device (on the CPU a step runs its body
    uncaptured), ``auto`` on CUDA, ``0`` never.  Never at ``verb > 3``:
    the cycle-QC trace (``var.level_all``) is written by the
    per-operation cycle only (the JAX package turns ``auto`` off there
    for the same reason).  Never under a grid placement, as in the JAX
    package: the pieces' halo copies run between the level operations.
    """
    mode = os.environ.get('EMG3D_TPU_CYCLE_JIT', 'auto')
    if var.verb > 3 or var.placement is not None:
        return False
    if mode == '1':
        return True
    return mode == 'auto' and var.device.type == 'cuda'


class _CycleCfg:
    """The static slice of MGParameters a cycle step reads."""

    __slots__ = ('cycle', 'cycmax', 'nu_init', 'nu_pre', 'nu_coarse',
                 'nu_post', 'level_all')

    def __init__(self, cycle, cycmax, nu_init, nu_pre, nu_coarse,
                 nu_post):
        self.cycle = cycle
        self.cycmax = cycmax
        self.nu_init = nu_init
        self.nu_pre = nu_pre
        self.nu_coarse = nu_coarse
        self.nu_post = nu_post
        self.level_all = []         # level-trace sink


def _cycle_cfg_key(var):
    return (var.cycle, var.cycmax, var.nu_init, var.nu_pre,
            var.nu_coarse, var.nu_post)


def _leaves(x):
    """The tensors of a nest of tuples of tensors and Nones, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif x is not None:
        for y in x:
            yield from _leaves(y)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return None if x is None else tuple(_clone(y) for y in x)


def _own_parts(lvl):
    """The tensors of a level, ``ops64`` left out where it is ``ops``."""
    return (lvl.ops, lvl.rw, lvl.pm,
            None if lvl.ops64 is lvl.ops else lvl.ops64)


class _LevelStore:
    """Static copies of the level tensors of one hierarchy layout.

    The steps captured on the layout read these copies.  ``load`` copies
    a solve's hierarchy in, once per hierarchy: a new ``Model`` on the
    same grid (every inversion evaluation, every survey task) then
    captures nothing.  The hierarchy is copied rather than built into
    the store, so that ``_Hierarchies`` and the per-operation cycle stay
    as they are and two hierarchies of one layout (two solves, or a solve
    and the batch engine) never share tensors.
    """

    def __init__(self, levels):
        self.levels = []
        for lvl in levels:
            new = _Level(_clone(lvl.ops), _clone(lvl.rw), _clone(lvl.pm))
            if lvl.ops64 is not None:
                new.ops64 = (new.ops if lvl.ops64 is lvl.ops
                             else _clone(lvl.ops64))
            self.levels.append(new)
        self._src = weakref.ref(levels[0])

    def load(self, levels):
        if self._src() is levels[0]:
            return
        for dst, src in zip(self.levels, levels):
            for d, t in zip(_leaves(_own_parts(dst)),
                            _leaves(_own_parts(src))):
                d.copy_(t)
        self._src = weakref.ref(levels[0])


class _CycleState:
    """The fine-grid tensors the steps of one grid read and write in place:
    the split iterate ``e_hi``, ``e_lo`` and the residual ``r`` in working
    precision, the source ``s`` and the norm ``l2`` in the precision of
    the level-0 operator."""

    def __init__(self, r, hdt):
        self.e_hi = tuple(torch.zeros_like(c) for c in r)
        self.e_lo = tuple(torch.zeros_like(c) for c in r)
        self.r = tuple(torch.zeros_like(c) for c in r)
        self.s = tuple(torch.zeros_like(c, dtype=hdt) for c in r)
        self.l2 = torch.zeros((), dtype=torch.float64, device=r[0].device)

    def start(self, s, r, e_hi=None):
        """Set the source, the residual and the iterate (zero if None)."""
        for dst, src in zip((self.s, self.r), (s, r)):
            for d, t in zip(dst, src):
                d.copy_(t)
        for d in self.e_lo:
            d.zero_()
        for i, d in enumerate(self.e_hi):
            if e_hi is None:
                d.zero_()
            else:
                d.copy_(e_hi[i])


def _cycle_state(r, ops64):
    """The state of the fine grid of ``r`` (the working precision) and of
    the level-0 operator ``ops64``, shared by every step on that grid."""
    key = (tuple(c.shape for c in r), r[0].dtype, ops64[0].dtype,
           r[0].device)
    state = _STATES.get(key)
    if state is None:
        state = _STATES[key] = _CycleState(r, ops64[0].dtype)
    return state


def _level_store(meta, levels):
    key = (tuple((shape, coarsen) for shape, _, coarsen in meta),
           levels[0].ops[0].dtype, levels[0].ops[0].device)
    store = _STORES.get(key)
    if store is None:
        store = _STORES[key] = _LevelStore(levels)
    store.load(levels)
    return store


class _CycleStep:
    """One multigrid cycle on ``state``: the correction from the residual
    ``state.r``, its split accumulate into ``state.e_hi``/``e_lo`` and,
    with ``store2``, the next residual and its norm with ``store2``'s
    level-0 operator, in place in ``state``.

    The first use runs the body operation by operation, which computes
    the cycle and loads every kernel it launches, and then captures the
    body into a CUDA graph; every later use replays the graph.  A capture
    that meets a host sync or a pageable copy raises, and nothing falls
    back.  On the CPU nothing is captured: every use runs the body.

    The kernels' launch counters count what passes through their
    wrappers: the eager first use and the launches recorded at capture.
    A replay runs the recorded kernels without the wrappers; it counts in
    ``CYCLE_REPLAYS`` and adds the launches its capture recorded
    (``launches``) to ``tracing``'s ``replayed_launches.*``, the capture
    itself to ``captured_launches.*``.
    """

    def __init__(self, meta, cfg_key, first, state, store, store2=None):
        self.meta = meta
        self.cfg = _CycleCfg(*cfg_key)
        self.first = first
        self.state = state
        self.store = store
        self.store2 = store2
        self.device = state.r[0].device
        self.graph = None
        self.captured = False
        self.launches = (0, 0)      # (gs_phase, line_phase) in the graph

    def _body(self):
        st = self.state
        self.cfg.level_all = []
        de = _cycle_correction(self.meta, self.store.levels, st.r, self.cfg,
                               self.first)
        _accumulate_(st.e_hi, st.e_lo, de)
        if self.store2 is not None:
            r, l2 = _residual_norm_split(st.e_hi, st.e_lo, st.s,
                                         self.store2.levels[0])
            for d, t in zip(st.r, r):
                d.copy_(t)
            st.l2.copy_(l2)

    def _capture(self):
        global CYCLE_CAPTURES, _POOL
        if self.device.type == 'cuda':
            if _POOL is None:
                _POOL = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            before = tracing.wrapper_launches()
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, pool=_POOL):
                self._body()
            self.launches = tuple(
                n - b for n, b in zip(tracing.wrapper_launches(), before))
            for k, n in zip(tracing.KERNELS, self.launches):
                tracing.count(f'captured_launches.{k}', n)
            self.graph = graph
        self.captured = True
        CYCLE_CAPTURES += 1

    def __call__(self):
        """Run the step; returns whether it replayed a graph."""
        global CYCLE_REPLAYS
        if not self.captured:
            self._body()
            self._capture()
            return False
        if self.graph is None:
            self._body()
        else:
            with torch.cuda.device(self.device):
                self.graph.replay()
            for k, n in zip(tracing.KERNELS, self.launches):
                tracing.count(f'replayed_launches.{k}', n)
        CYCLE_REPLAYS += 1
        return self.graph is not None


def _cached_step(key, make):
    """The step of ``key`` from the cache (made by ``make()`` if absent)."""
    step = _STEPS.get(key)
    if step is None:
        tracing.count('step_misses')
        step = _STEPS[key] = make()
        while len(_STEPS) > _MAX_STEPS:
            tracing.count('step_evictions')
            _STEPS.popitem(last=False)
    else:
        _STEPS.move_to_end(key)
    return step


def _whole_step(meta, meta2, cfg_key, first, state, levels, levels2):
    """Run one cycle, its accumulate and the next residual as a step;
    returns the norm (the one host sync of the cycle).

    ``meta``/``levels`` are the current hierarchy, ``meta2``/``levels2``
    the next one (they differ under semicoarsening or line-relaxation
    cycling); ``first`` is whether the cycle's initial smoothing runs
    (the first cycle with ``nu_init > 0``).  The step is cached on
    ``(meta, meta2, cfg_key, first)``, the working dtype and the device.
    """
    with tracing.span('emg3d.cycle.step') as sp:
        store = _level_store(meta, levels)
        store2 = _level_store(meta2, levels2)
        key = ('step', meta, meta2, cfg_key, first, state.r[0].dtype,
               state.r[0].device)
        sp.set(replayed=_cached_step(key, lambda: _CycleStep(
            meta, cfg_key, first, state, store, store2))())
        return _scalar(state.l2)


def _whole_corr(meta, cfg_key, first, state, levels):
    """Run one cycle and its accumulate as a step, without the next
    residual: the last cycle of the preconditioner."""
    with tracing.span('emg3d.cycle.step') as sp:
        store = _level_store(meta, levels)
        key = ('corr', meta, cfg_key, first, state.r[0].dtype,
               state.r[0].device)
        sp.set(replayed=_cached_step(key, lambda: _CycleStep(
            meta, cfg_key, first, state, store))())


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

    s = hier.to_dev(sfield, wdt)
    e_hi = hier.to_dev(efield, wdt)
    e_lo = tuple(torch.zeros_like(c) for c in e_hi)

    r, l2 = _residual_norm_split(e_hi, e_lo, s, levels[0])
    l2_last = _scalar(l2)
    l2_stag = np.ones(var.maxcycle) * l2_last

    graph = _use_cycle_graph(var)
    if graph:
        state = _cycle_state(r, levels[0].ops64)
        state.start(s, r, e_hi)
        e_hi, e_lo = state.e_hi, state.e_lo
        cfg_key = _cycle_cfg_key(var)

    it = 0
    first = True
    while True:
        l2_prev = l2_last
        l2_stag[(it - 1) % var.maxcycle] = l2_last

        # Cycle semicoarsening and line-relaxation directions (applied
        # to the NEXT residual evaluation, reference solver.py:639-642).
        sc_next, lr_next = _next_dirs(var)

        meta2, levels2 = hier.get(sc_next, lr_next)
        if graph:
            l2_last = _whole_step(meta, meta2, cfg_key,
                                  first and var.nu_init > 0, state, levels,
                                  levels2)
        else:
            with tracing.span('emg3d.cycle.step', replayed=False):
                de = _cycle_correction(meta, levels, r, var, first)
                _accumulate_(e_hi, e_lo, de)
                r, l2 = _residual_norm_split(e_hi, e_lo, s, levels2[0])
                l2_last = _scalar(l2)
        meta, levels = meta2, levels2
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
    with tracing.span('emg3d.fields.to_host'):
        out = fields.Field(efield.grid, dtype=dtype,
                           frequency=efield._frequency)
        out.fx, out.fy, out.fz = (
            _to_host(h).astype(dtype) + _to_host(lo).astype(dtype)
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
    lvl0 = hier.get(var.sc_dir, var.lr_dir)[1][0]
    hdt = _host_dtypes(model)[0]
    wdt = hier.dtypes[0]

    def amatvec(e):
        if lvl0.sharded:
            return lvl0.amat(e)
        return operator.amat_x(*e, *lvl0.ops64)

    graph = _use_cycle_graph(var)
    cfg_key = _cycle_cfg_key(var)

    def mg_precond(s):
        """Apply up-to-maxcycle MG cycles to s, starting from zero.

        Mirrors the reference's use of multigrid as the preconditioner
        (solver.py:710-728), incl. the divergence/stagnation abort of the
        outer Krylov solver via _ConvergenceError.
        """
        r = tuple(c.to(wdt) for c in s)
        if graph:
            state = _cycle_state(r, lvl0.ops64)
            state.start(s, r)
            e_hi, e_lo = state.e_hi, state.e_lo
        else:
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
            first_eff = first and var.nu_init > 0

            if graph and last:
                _whole_corr(meta, cfg_key, first_eff, state, levels)
            elif graph:
                meta2, levels2 = hier.get(sc_next, lr_next)
                l2_last = _whole_step(meta, meta2, cfg_key, first_eff,
                                      state, levels, levels2)
            else:
                with tracing.span('emg3d.cycle.step', replayed=False):
                    de = _cycle_correction(meta, levels, r, var, first)
                    _accumulate_(e_hi, e_lo, de)
                    if not last:
                        _, levels2 = hier.get(sc_next, lr_next)
                        r, l2 = _residual_norm_split(e_hi, e_lo, s,
                                                     levels2[0])
                        l2_last = _scalar(l2)
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

    s = hier.to_dev(sfield, hdt)
    e = hier.to_dev(efield, hdt)

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
    real tensors); over owned entries of sharded fields."""
    if isinstance(a[0], torch.Tensor):
        val = sum(torch.vdot(x.reshape(-1), y.reshape(-1))
                  for x, y in zip(a, b))
    else:
        dev = a[0].layout.devices()[0]
        val = sum(x.vdot(y, dev) for x, y in zip(a, b))
    return _scalar(val)


def _norm_tup(a):
    if isinstance(a[0], torch.Tensor):
        return _scalar(torch.sqrt(sum(torch.sum(torch.abs(x) ** 2)
                                      for x in a)))
    dev = a[0].layout.devices()[0]
    return _scalar(torch.sqrt(sum(x.sqsum(dev) for x in a)))


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
        return _scalar(operator.residual_norm(*r))
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
            rw.append(tuple(_to_device(x, device, dtypes[1]) for x in w))
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
            pm.append((_to_device(idx, device),
                       _to_device(w, device, dtypes[1])))
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
        self.placement = None   # GridPlacement of a grid-sharded solve

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
