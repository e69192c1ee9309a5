"""Batched multi-(source, frequency) solves on one device (PyTorch).

Port of ``emg3d_tpu.parallel.batch``.  The reference parallelizes a
survey by pickling one task per (source, frequency) to a process pool
(emg3d/_multiprocessing.py:33-69, emg3d/simulations.py:860-866).  Here
the tasks become a leading task axis of every field tensor: the
multigrid cycle runs once for the whole batch, each smoothing phase is
one launch of the ``gs_phase`` or ``line_phase`` kernel for all tasks
(the kernels take a task index), residual and transfers broadcast over
the axis, and BiCGSTAB's scalars become one per task.  The cycle and
its level operations are the solver's own (``solver._cycle_correction``),
which read the task axis and a level's scale.

All tasks of one batched solve share the grid; the Simulation layer
groups tasks by computational grid and runs one batched solve per group
(``Simulation._batch_groups``).

Two hierarchy layouts (:func:`_build_hierarchy_batched`): without
``epsilon_r`` eta is linear in s, so every task shares one eta and
carries a scale ``s_k / s_0`` (``_Level.scale``); with it, eta is
stacked per task.

Not carried over from the JAX module, for one card: the device mesh
(``make_task_mesh``, ``mesh``, ``axis``, padding to the mesh size and the
``NamedSharding`` placements); the pre-blocked smoother operands
(``blk``/``blk_t``; the port has no ``ops/blocked.py``); the
double-single residual (Hopper has FP64: the residual is evaluated in
native complex128/float64).
"""

import dataclasses
import os
import time

import numpy as np
import torch

from emg3d_tpu_torch import fields, models, solver
from emg3d_tpu_torch.ops import operator

__all__ = ["solve_batch", "solve_batch_fields"]


class _BatchHierarchies(solver._Hierarchies):
    """Per-solve cache of batched hierarchies per (sc_dir, lr_dir).

    Batched counterpart of ``solver._Hierarchies`` (the same caching: the
    level tensors per sc_dir, the line-relaxation flags per lr_dir);
    ``scales`` selects the shared-eta layout.
    """

    def __init__(self, vmodels, var, scales=None):
        super().__init__(vmodels[0], var)
        self.vmodels = vmodels
        self.scales = scales

    def _build(self, sc_dir, lr_dir, clevel_max):
        return _build_hierarchy_batched(
            self.vmodels, sc_dir, lr_dir, clevel_max, self.var.device,
            self.dtypes, self.scales)


def _build_hierarchy_batched(vmodels, sc_dir, lr_dir, clevel_max, device,
                             dtypes, scales=None):
    """Batched hierarchy in one of two layouts.

    With ``scales`` (the shared-eta layout): ONE hierarchy is built, from
    ``vmodels[0]``, and every level carries the per-task scale (B,) in
    working precision (``scale``; level 0 also in the precision of its
    ``ops64``, ``scale64``): task k's eta is exactly ``scales[k] * eta``
    (eta is linear in s without epsilon_r, and model restriction is
    linear), so the device holds O(cells) model data, not O(B * cells).

    Without ``scales``: one hierarchy per task, with eta stacked on a
    leading task axis (the general case, e.g. epsilon_r); zeta, widths
    and transfer weights are shared.
    """
    if scales is not None:
        meta, levels = solver._build_hierarchy(
            vmodels[0], sc_dir, lr_dir, clevel_max, device, dtypes)
        sc = torch.from_numpy(np.asarray(scales))
        for lvl in levels:
            lvl.scale = sc.to(device=device, dtype=dtypes[0])
            if lvl.ops64 is not None:
                lvl.scale64 = sc.to(device=device, dtype=lvl.ops64[0].dtype)
        return meta, levels

    metas, per_task = zip(*(
        solver._build_hierarchy(vm, sc_dir, lr_dir, clevel_max, device,
                                dtypes) for vm in vmodels))
    if any(m != metas[0] for m in metas[1:]):
        raise ValueError("All tasks must share the same grid hierarchy.")

    def stacked(k, name):
        ops = [getattr(pt[k], name) for pt in per_task]
        return (*(torch.stack([o[i] for o in ops]) for i in range(3)),
                *ops[0][3:])

    levels = []
    for k, lvl in enumerate(per_task[0]):
        levels.append(solver._Level(
            stacked(k, "ops"), lvl.rw, lvl.pm,
            None if lvl.ops64 is None else stacked(k, "ops64")))
    return metas[0], levels


# --------------------------------------------------------------------------
# Active shrink (straggler recompaction).
#
# Converged tasks still occupy lanes: the batch runs matvecs and
# preconditioner cycles for them in lockstep.  When enough tasks have
# converged, the batch is recompacted to half (a quarter, ...) its size,
# as in the JAX package.  Opt-in via EMG3D_TPU_BATCH_SHRINK=1 (read per
# solve; the same variable as the JAX package's).
# --------------------------------------------------------------------------

def _shrink_on():
    return os.environ.get("EMG3D_TPU_BATCH_SHRINK", "0") == "1"


def _shrink_size(ntask, n_active):
    """Largest halving of ``ntask`` that holds all active tasks."""
    floor = max(int(n_active), 1)
    new = int(ntask)
    while new // 2 >= floor:
        new //= 2
    return new


def _keep_lanes(active, new_n):
    """Lane selection for a shrink: every active lane, padded with
    already-converged lanes up to new_n (their x stays frozen by the
    active gating; they only waste the smaller batch's flops)."""
    act = np.flatnonzero(active)
    inact = np.flatnonzero(~active)
    return np.concatenate([act, inact[:new_n - act.size]])


def _take_fields(fs, keep):
    idx = torch.as_tensor(keep, device=fs[0].device)
    return tuple(c.index_select(0, idx) for c in fs)


def _take_level(lvl, keep):
    """The level for the lanes ``keep``: its scales, or its stacked eta."""
    def take(t):
        return None if t is None else _take_fields((t,), keep)[0]

    def take_ops(ops):
        if ops is None or ops[0].dim() != 4:
            return ops
        return (*_take_fields(ops[:3], keep), *ops[3:])

    return dataclasses.replace(
        lvl, ops=take_ops(lvl.ops), ops64=take_ops(lvl.ops64),
        scale=take(lvl.scale), scale64=take(lvl.scale64))


class _SelectedHierarchies:
    """Lane-sliced view of a (possibly already sliced) hierarchy cache."""

    def __init__(self, parent, keep):
        self.parent = parent
        self.keep = np.asarray(keep)
        self.dtypes = parent.dtypes
        self._cache = {}

    def get(self, sc_dir, lr_dir):
        key = (int(sc_dir), int(lr_dir))
        if key not in self._cache:
            meta, levels = self.parent.get(sc_dir, lr_dir)
            self._cache[key] = (meta, [_take_level(lvl, self.keep)
                                       for lvl in levels])
        return self._cache[key]


# --------------------------------------------------------------------------
# Batched MG-preconditioned BiCGSTAB.
#
# The reference's production configuration (sslsolver + semicoarsening +
# linerelaxation, emg3d/solver.py:82-140) for the whole batch at once: the
# Krylov scalars become (B,) device tensors (one (rho, alpha, omega) per
# task) and every vector operation is batched over the task axis.  The
# vectors are complex128/float64, as in ``solver.krylov``; the
# preconditioner runs in the working precision.  Per-task convergence is
# an ``active`` mask that freezes a task's x once its residual passes the
# tolerance; guarded divisions make post-breakdown algebra inert (zeros)
# instead of NaN.
# --------------------------------------------------------------------------

def _bdot(a, b):
    """Per-task conjugated inner product over field tuples -> (B,)."""
    return sum(torch.sum(torch.conj(x) * y, dim=(1, 2, 3))
               for x, y in zip(a, b))


def _bnorm_dev(a):
    """Per-task l2 norm over field tuples -> (B,) real."""
    return torch.sqrt(sum(torch.sum(torch.abs(x) ** 2, dim=(1, 2, 3))
                          for x in a))


def _guarded_div(num, den):
    """num/den with 0 on breakdown (zero denominator OR a non-finite
    quotient, e.g. a denormal-underflow denominator overflowing the
    ratio) so broken-down tasks' algebra stays inert instead of NaN."""
    bad = den == 0
    q = torch.where(bad, 0, num / torch.where(bad, 1, den))
    return torch.where(torch.isfinite(q), q, 0)


def _bxpay(x, a, y):
    """x + a*y with per-task scalar a, over field tuples."""
    return tuple(c + a[:, None, None, None] * d for c, d in zip(x, y))


def _bcg_direction(r, rhat, p, v, rho, alpha, omega, first):
    """rho/beta update and new search direction p."""
    rho_new = _bdot(rhat, r)
    if first:
        return r, rho_new
    beta = _guarded_div(rho_new, rho) * _guarded_div(alpha, omega)
    beta = torch.where(torch.isfinite(beta), beta, 0)
    p_new = _bxpay(r, beta, _bxpay(p, -omega, v))
    return p_new, rho_new


def _bcg_alpha(phat, r, rhat, rho, lvl):
    """v = A phat; alpha = rho/<rhat,v>; s = r - alpha v."""
    v = _bamat(phat, lvl)
    alpha = _guarded_div(rho, _bdot(rhat, v))
    svec = _bxpay(r, -alpha, v)
    return v, alpha, svec


def _bcg_advance(shat, phat, svec, x, alpha, active, lvl):
    """t = A shat; omega; masked x/r updates; new residual norms.

    Converged lanes are frozen by *selection* on the task mask, not by
    zeroing the step: an active-lane breakdown can yield non-finite
    Krylov scalars, and ``0 * NaN`` in a multiplicative gate would
    still overwrite a frozen, already-converged solution with NaN.
    """
    t = _bamat(shat, lvl)
    omega = _guarded_div(_bdot(t, svec), _bdot(t, t))
    x_upd = _bxpay(_bxpay(x, alpha, phat), omega, shat)
    sel = active[:, None, None, None]
    x_new = tuple(torch.where(sel, u, c) for u, c in zip(x_upd, x))
    r_new = _bxpay(svec, -omega, t)
    return x_new, r_new, omega, _bnorm_dev(r_new)


def _bamat(e, lvl):
    """Batched operator application (B tasks at once), with the level-0
    operator in the precision of the Krylov vectors."""
    return operator.amat_x(*e, *solver._scaled(lvl.ops64, lvl.scale64))


def _bprecond(s, var, bhier):
    """Apply ``var.maxit`` batched MG cycles to s from a zero guess.

    Batched counterpart of the per-task preconditioner (``mg_precond``
    in ``solver.krylov``): split-precision accumulation inside, sc/lr
    direction cycling shared with the outer loop via ``var``.  Runs a
    fixed cycle count (per-task early exit would desynchronize the
    batch); the count is the small ``maxcycle`` (e.g. 3) the reference
    also uses as its inner budget.
    """
    r = tuple(c.to(bhier.dtypes[0]) for c in s)
    e_hi = tuple(torch.zeros_like(c) for c in r)
    e_lo = tuple(torch.zeros_like(c) for c in r)
    for cyc in range(var.maxit):
        sc_next, lr_next = solver._next_dirs(var)
        meta, levels = bhier.get(var.sc_dir, var.lr_dir)
        de = solver._cycle_correction(meta, levels, r, var, cyc == 0)
        solver._accumulate_(e_hi, e_lo, de)
        var.sc_dir, var.lr_dir = sc_next, lr_next
        var.it += 1
        if cyc + 1 < var.maxit:
            r, _ = solver._residual_norm_split(e_hi, e_lo, s, levels[0],
                                               per_task=True)
    hdt = s[0].dtype
    return tuple(h.to(hdt) + lo.to(hdt) for h, lo in zip(e_hi, e_lo))


def _restore_lanes(x, cur, stash, ntask):
    """The full batch from the lanes ``cur`` of ``x`` and the ``stash``
    ({task: field tuple}) of the lanes a shrink dropped."""
    if cur.size == ntask:
        return x
    out = dict(stash)
    for lane, task in enumerate(cur):
        out[int(task)] = tuple(c[lane] for c in x)
    return tuple(torch.stack([out[k][j] for k in range(ntask)])
                 for j in range(3))


def _bicgstab_batch(s, var, bhier, verb=0, x0=None):
    """Right-preconditioned BiCGSTAB over the task batch.

    Batched counterpart of ``solver._bicgstab`` (reference role:
    emg3d/solver.py:759-765).  ``x0`` warm-starts the iteration (the
    initial residual is then s - A x0).  Returns
    (x, rnorm, it, converged_mask).
    """
    arrs0 = bhier.get(var.sc_dir, var.lr_dir)[1][0]

    bnrm = _bnorm_dev(s).cpu().numpy()
    atol = np.maximum(1e-30, var.tol * np.where(bnrm == 0, 1.0, bnrm))
    ones = torch.ones(bnrm.shape, dtype=s[0].dtype, device=s[0].device)

    if x0 is None:
        x = tuple(torch.zeros_like(c) for c in s)
        r = s                        # r = s - A·0
        rnorm = bnrm.copy()
    else:
        x = x0
        r = _bxpay(s, -ones, _bamat(x, arrs0))
        rnorm = _bnorm_dev(r).cpu().numpy()
    rhat = r
    rho = alpha = omega = ones
    v = p = tuple(torch.zeros_like(c) for c in s)

    # Zero-source (or already-converged warm-started) tasks: born done.
    active = (bnrm > 0) & (rnorm >= atol)
    if not active.any():
        return x, rnorm, 0, rnorm < atol

    # Lane bookkeeping for active shrink: ``cur[lane]`` is the original
    # task index held by lane ``lane``; dropped (converged) tasks'
    # solutions are stashed at shrink time.
    ntask = active.size
    cur = np.arange(ntask)
    stash = {}
    shrink = _shrink_on()

    it = 0
    for it in range(1, var.ssl_maxit + 1):
        p, rho = _bcg_direction(r, rhat, p, v, rho, alpha, omega,
                                first=it == 1)
        phat = _bprecond(p, var, bhier) if var.cycle else p
        v, alpha, svec = _bcg_alpha(phat, r, rhat, rho, arrs0)
        shat = _bprecond(svec, var, bhier) if var.cycle else svec
        x, r, omega, rnorm_dev = _bcg_advance(
            shat, phat, svec, x, alpha,
            torch.as_tensor(active[cur], device=s[0].device), arrs0)

        rnorm[cur] = np.where(active[cur], rnorm_dev.cpu().numpy(),
                              rnorm[cur])
        active = active & (rnorm >= atol)
        var.ssl_it += 1
        if verb > 3:
            rel = rnorm / np.where(bnrm == 0, 1.0, bnrm)
            print(f"   ssl it {it:3}: max rel error {rel.max():.3e} "
                  f"({(~active).sum()}/{active.size} converged)")
        if not active.any():
            break

        if shrink:
            new_n = _shrink_size(cur.size, int(active[cur].sum()))
            if new_n < cur.size:
                keep = _keep_lanes(active[cur], new_n)
                for lane in np.setdiff1d(np.arange(cur.size), keep):
                    stash[int(cur[lane])] = tuple(c[lane] for c in x)
                x, r, rhat, v, p = (_take_fields(f, keep)
                                    for f in (x, r, rhat, v, p))
                rho, alpha, omega = _take_fields((rho, alpha, omega), keep)
                bhier = _SelectedHierarchies(bhier, keep)
                arrs0 = _take_level(arrs0, keep)
                cur = cur[keep]
                if verb > 3:
                    print(f"   ssl it {it:3}: batch shrunk to "
                          f"{cur.size}/{ntask} lanes")

    return _restore_lanes(x, cur, stash, ntask), rnorm, it, rnorm < atol


def _multigrid_batch(s, x0, var, bhier, l2_refe, verb=0):
    """Stand-alone multigrid cycles over the task batch.

    Batched counterpart of ``solver.multigrid``: the split iterate
    ``e_hi + e_lo`` in working precision, the per-task residual in
    double precision; a task is finished once converged or diverged, and
    the batch cycles until every task is.  Returns (x as a double-
    precision tuple, per-task norms, cycles, exit messages).
    """
    e_hi = (x0 if x0 is not None
            else tuple(torch.zeros_like(c) for c in s))
    e_lo = tuple(torch.zeros_like(c) for c in s)
    hdt = bhier.get(var.sc_dir, var.lr_dir)[1][0].ops64[0].dtype
    ntask = s[0].shape[0]

    # Active-shrink bookkeeping (see _shrink_size): ``cur[lane]`` is the
    # original task on lane ``lane``; finished tasks recompacted away are
    # stashed with their combined field and exit message.
    cur = np.arange(ntask)
    stash = {}
    l2_full = np.zeros(ntask)
    exit_full = ["MAX. ITERATION REACHED, NOT CONVERGED"] * ntask
    shrink = _shrink_on()

    it = 0
    first = True
    while True:
        meta, levels = bhier.get(var.sc_dir, var.lr_dir)
        r, l2_dev = solver._residual_norm_split(e_hi, e_lo, s, levels[0],
                                                per_task=True)
        l2 = l2_dev.cpu().numpy()
        l2_full[cur] = l2

        rel = l2 / l2_refe[cur]
        done = rel < var.tol
        diverged = ~np.isfinite(l2) | (l2 > 10 * l2_refe[cur])
        if verb > 3 and it > 0:
            print(f"   cycle {it:3}: max rel error {rel.max():.3e} "
                  f"({done.sum() + len(stash)}/{ntask} converged)")
        finished = done | diverged
        if np.all(finished) or it >= var.maxit:
            for lane, oi in enumerate(cur):
                exit_full[oi] = (
                    "CONVERGED" if done[lane] else
                    "DIVERGED" if diverged[lane] else
                    "MAX. ITERATION REACHED, NOT CONVERGED")
            break

        if shrink:
            new_n = _shrink_size(cur.size, int((~finished).sum()))
            if new_n < cur.size:
                keep = _keep_lanes(~finished, new_n)
                for lane in np.setdiff1d(np.arange(cur.size), keep):
                    stash[int(cur[lane])] = tuple(
                        h[lane].to(hdt) + lo[lane].to(hdt)
                        for h, lo in zip(e_hi, e_lo))
                    exit_full[int(cur[lane])] = (
                        "CONVERGED" if done[lane] else "DIVERGED")
                e_hi, e_lo, s, r = (_take_fields(f, keep)
                                    for f in (e_hi, e_lo, s, r))
                bhier = _SelectedHierarchies(bhier, keep)
                meta, levels = bhier.get(var.sc_dir, var.lr_dir)
                cur = cur[keep]
                if verb > 3:
                    print(f"   cycle {it:3}: batch shrunk to "
                          f"{cur.size}/{ntask} lanes")

        sc_next, lr_next = solver._next_dirs(var)
        de = solver._cycle_correction(meta, levels, r, var, first)
        first = False
        solver._accumulate_(e_hi, e_lo, de)
        var.sc_dir, var.lr_dir = sc_next, lr_next
        it += 1

    # Combine the split field in double precision so that the algebraic
    # accuracy survives the export.
    x = tuple(h.to(hdt) + lo.to(hdt) for h, lo in zip(e_hi, e_lo))
    return (_restore_lanes(x, cur, stash, ntask), l2_full, it, exit_full)


def solve_batch(model, sources, frequencies, verb=0, **kwargs):
    """Solve one model for many (source, frequency) tasks at once.

    Parameters
    ----------
    model : Model
        Resistivity model (shared grid for all tasks).
    sources : list
        Source definitions (coordinate tuples or electrode instances),
        one per task.
    frequencies : list of float
        One frequency per task (same length as ``sources``).
    kwargs
        Solver options as for solve(): tol, maxit, cycle, sslsolver,
        semicoarsening, linerelaxation, nu_*, clevel, ``device`` (None:
        the card; without one it raises) and ``dtype`` (the working
        dtype); plus optional ``efields`` (warm-start guesses).  Defaults
        are plain multigrid cycles; ``sslsolver=True`` runs the
        production configuration (batched MG-preconditioned BiCGSTAB;
        'cgs' and 'gcrotmk' have no batched form).

    Returns
    -------
    efields : list of Field
    info : dict
        Per-task iteration counts, errors, and exit messages.
    """
    if len(frequencies) != len(sources):
        raise ValueError("sources and frequencies must have equal length.")
    sfields = [fields.get_source_field(model.grid, src, freq)
               for src, freq in zip(sources, frequencies)]
    return solve_batch_fields(model, sfields, verb=verb, **kwargs)


def solve_batch_fields(model, sfields, verb=0, efields=None, **kwargs):
    """Batched solve for prebuilt source fields (one per task).

    Engine behind :func:`solve_batch`; also the batch-mode carrier of
    the Simulation's adjoint (residual source fields, ``_bcompute``)
    and sensitivity (``jvec``) solves, whose right-hand sides are
    arbitrary fields rather than dipole sources (reference
    emg3d/simulations.py:1193-1233, 1270-1397).

    ``efields`` (list of Field or None, per task) warm-starts each
    task; already-converged guesses terminate with zero iterations.
    """
    t0 = time.perf_counter()
    ntask = len(sfields)

    kwargs.setdefault("sslsolver", False)
    kwargs.setdefault("semicoarsening", False)
    kwargs.setdefault("linerelaxation", False)
    var = solver.MGParameters(
        shape_cells=model.shape, verb=verb, **kwargs)
    if var.sslsolver and var.sslsolver != 'bicgstab':
        raise ValueError(
            f"sslsolver='{var.sslsolver}' has no batched form; use "
            "'bicgstab' (or parallel='task').")

    guesses = list(efields) if efields is not None else None
    if guesses is not None and not any(g is not None for g in guesses):
        guesses = None

    # Shared-eta layout: all tasks see the SAME model, and without
    # epsilon_r eta is linear in s: task k's eta is (s_k/s_0) times
    # task 0's, at every hierarchy level (restriction is linear).  One
    # eta copy + a (B,) scale vector then replaces the stacked etas.
    if model.epsilon_r is None:
        vmodels = [models.VolumeModel(model, sfields[0])]
        scales = [sf.smu0 / sfields[0].smu0 for sf in sfields]
    else:
        vmodels = [models.VolumeModel(model, sf) for sf in sfields]
        scales = None
    bhier = _BatchHierarchies(vmodels, var, scales)

    # The Krylov vectors are double precision (as in solver.krylov);
    # stand-alone multigrid keeps its source in working precision.
    dt = (solver._host_dtypes(vmodels[0])[0] if var.sslsolver
          else bhier.dtypes[0])
    s = tuple(torch.stack(c) for c in zip(
        *[solver._field_to_dev(sf, var.device, dt) for sf in sfields]))

    # Warm-start stack: per-task initial guesses (zeros where absent).
    x0 = None
    if guesses is not None:
        x0 = tuple(torch.stack(c) for c in zip(*[
            tuple(torch.zeros_like(c[0]) for c in s) if g is None
            else solver._field_to_dev(g, var.device, dt) for g in guesses]))

    l2_refe = np.array([np.linalg.norm(sf.field) for sf in sfields])
    l2_refe = np.where(l2_refe == 0.0, 1.0, l2_refe)

    if var.sslsolver:
        x, l2, it_ssl, conv = _bicgstab_batch(s, var, bhier, verb=verb,
                                              x0=x0)
        exit_messages = ["CONVERGED" if c else
                         "MAX. ITERATION REACHED, NOT CONVERGED"
                         for c in conv]
        it_mg = var.it
    else:
        x, l2, it_mg, exit_messages = _multigrid_batch(
            s, x0, var, bhier, l2_refe, verb=verb)
        it_ssl = 0

    # Unstack into Fields.
    ex, ey, ez = (c.cpu().numpy() for c in x)
    out = []
    for i, sf in enumerate(sfields):
        f = fields.Field(model.grid, dtype=sf.field.dtype,
                         frequency=sf._frequency)
        f.fx, f.fy, f.fz = ex[i], ey[i], ez[i]
        out.append(f)

    info = {
        "it_mg": it_mg,
        "it_ssl": it_ssl,
        "abs_error": l2,
        "rel_error": l2 / l2_refe,
        "ref_error": l2_refe,
        "exit_messages": exit_messages,
        "tol": var.tol,
        # Wall clock of the whole batch (tasks run fused, there is no
        # meaningful per-task split).
        "runtime": round(time.perf_counter() - t0, 3),
    }
    return out, info
