"""Batched multi-(source, frequency) solves over a list of devices.

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

The task axis is split over the entries of a 1-D device mesh
(:func:`make_task_mesh`, ``mesh=``), as the JAX package shards it: one
contiguous chunk of lanes per entry, each with its own level tensors on
its device, the batch padded to a multiple of the mesh size with copies
of the last task.  One host loop drives every chunk and decides for all
lanes together: per cycle it issues every chunk's residual norm, reads
all lanes' norms with one sync, then issues every chunk's correction.
Entries may repeat a device (``['cuda:0'] * 4``).

All tasks of one batched solve share the grid; the Simulation layer
groups tasks by computational grid and runs one batched solve per group
(``Simulation._batch_groups``).

Two hierarchy layouts (:func:`_build_hierarchy_batched`): without
``epsilon_r`` eta is linear in s, so every task shares one eta and
carries a scale ``s_k / s_0`` (``_Level.scale``); with it, eta is
stacked per task.

Not carried over from the JAX module: the pre-blocked smoother operands
(``blk``/``blk_t``; the port has no ``ops/blocked.py``); the double-single
residual (Hopper has FP64: the residual is evaluated in native
complex128/float64).
"""

import dataclasses
import os
import time

import numpy as np
import torch

from emg3d_tpu_torch import fields, models, solver, tracing
from emg3d_tpu_torch.ops import operator
from emg3d_tpu_torch.parallel import domain

__all__ = ["solve_batch", "solve_batch_fields", "make_task_mesh"]


def make_task_mesh(n_devices=None, devices=None, axis="task"):
    """A 1-D device mesh over (the first ``n_devices`` of) ``devices``.

    ``devices``: a list of devices (an entry may repeat, e.g.
    ``['cuda:0'] * 4`` or ``['cpu'] * 3``); default every CUDA card, and
    without one it raises.
    """
    devs = domain.device_list(n_devices, devices)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return domain.DeviceGrid(grid, (axis,))


class _BatchHierarchies(solver._Hierarchies):
    """Per-solve cache of batched hierarchies per (sc_dir, lr_dir).

    Batched counterpart of ``solver._Hierarchies`` (the same caching: the
    level tensors per sc_dir, the line-relaxation flags per lr_dir);
    ``scales`` selects the shared-eta layout.
    """

    def __init__(self, vmodels, var, scales=None, device=None):
        super().__init__(vmodels[0], var, device)
        self.vmodels = vmodels
        self.scales = scales

    def _build(self, sc_dir, lr_dir, clevel_max):
        return _build_hierarchy_batched(
            self.vmodels, sc_dir, lr_dir, clevel_max, self.device,
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
        sc = np.asarray(scales)
        with tracing.span('emg3d.hierarchy.to_device'):
            for lvl in levels:
                lvl.scale = solver._to_device(sc, device, dtypes[0])
                if lvl.ops64 is not None:
                    lvl.scale64 = solver._to_device(sc, device,
                                                    lvl.ops64[0].dtype)
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
# The lanes of a batch, in chunks over the mesh.
# --------------------------------------------------------------------------

class _Lanes:
    """The lanes of a batch in contiguous chunks, one per mesh entry.

    ``tasks[lane]`` is the task a lane holds (lanes are recompacted by an
    active shrink); chunk c holds the lanes ``bounds[c]`` on
    ``devices[c]``, with its hierarchy ``hiers[c]`` (``make_hier(tasks of
    the chunk, device)``).  A batched field is a list of per-chunk tuples
    of tensors with a leading lane axis.
    """

    def __init__(self, devices, tasks, make_hier):
        self.devices = list(devices)
        self.tasks = np.asarray(tasks)
        self.make_hier = make_hier
        m = self.tasks.size // len(self.devices)
        self.bounds = [(c * m, (c + 1) * m) for c in range(len(devices))]
        self.hiers = [make_hier(self.tasks[a:b], dev)
                      for (a, b), dev in zip(self.bounds, self.devices)]

    @property
    def dtypes(self):
        return self.hiers[0].dtypes

    def get(self, sc_dir, lr_dir):
        """Every chunk's (meta, levels)."""
        return [h.get(sc_dir, lr_dir) for h in self.hiers]

    def split(self, a, dtype=None):
        """A host array over the lanes -> per-chunk device tensors."""
        return [solver._to_device(a[lo:hi], dev, dtype)
                for (lo, hi), dev in zip(self.bounds, self.devices)]

    def host(self, chunks):
        """Per-chunk device tensors over lanes -> one host array (one
        sync)."""
        dev = self.devices[0]
        return solver._scalar(torch.cat([c.to(dev) for c in chunks]))

    def lane(self, fs, lane):
        """Lane ``lane`` of a batched field: a tuple of tensors."""
        for c, (lo, hi) in enumerate(self.bounds):
            if lo <= lane < hi:
                return tuple(x[lane - lo] for x in fs[c])
        raise IndexError(lane)

    def select(self, keep):
        """The lanes ``keep``, recompacted over the same mesh entries."""
        return _Lanes(self.devices, self.tasks[keep], self.make_hier)

    def take(self, fs, keep, new):
        """A batched field (or a per-chunk list of lane vectors) on the
        lanes ``keep``, in the chunks of ``new`` (``select(keep)``)."""
        single = isinstance(fs[0], torch.Tensor)
        fs = [(x,) if single else x for x in fs]
        out = []
        for (lo, hi), dev in zip(new.bounds, new.devices):
            lanes = [self.lane(fs, int(k)) for k in keep[lo:hi]]
            out.append(tuple(torch.stack([ln[j].to(dev) for ln in lanes])
                             for j in range(len(fs[0]))))
        return [x[0] for x in out] if single else out


def _to_lanes(lanes, per_task):
    """Per-task tuples of host tensors -> a batched field of ``lanes``."""
    return [tuple(torch.stack([solver._to_device(per_task[t][j], dev)
                               for t in range(lo, hi)]) for j in range(3))
            for (lo, hi), dev in zip(lanes.bounds, lanes.devices)]


def _from_lanes(fs):
    """A batched field -> a tuple of host arrays over all lanes."""
    with tracing.span('emg3d.fields.to_host'):
        return tuple(np.concatenate([solver._to_host(c[j]) for c in fs])
                     for j in range(3))


# --------------------------------------------------------------------------
# Active shrink (straggler recompaction).
#
# Converged tasks still occupy lanes: the batch runs matvecs and
# preconditioner cycles for them in lockstep.  When enough tasks have
# converged, the batch is recompacted to half (a quarter, ...) its size,
# a multiple of the mesh size, as in the JAX package.  Opt-in via
# EMG3D_TPU_BATCH_SHRINK=1 (read per solve; the same variable as the JAX
# package's).
# --------------------------------------------------------------------------

def _shrink_on():
    return os.environ.get("EMG3D_TPU_BATCH_SHRINK", "0") == "1"


def _shrink_size(ntask, n_active, nd=1):
    """Largest halving of ``ntask`` that holds all active tasks, a
    multiple of the mesh size ``nd``."""
    nd = max(int(nd), 1)
    floor = max(int(n_active), nd, 1)
    new = int(ntask)
    while new // 2 >= floor and (new // 2) % nd == 0:
        new //= 2
    return new


def _keep_lanes(active, new_n):
    """Lane selection for a shrink: every active lane, padded with
    already-converged lanes up to new_n (their x stays frozen by the
    active gating; they only waste the smaller batch's flops)."""
    act = np.flatnonzero(active)
    inact = np.flatnonzero(~active)
    return np.concatenate([act, inact[:new_n - act.size]])


def _take_level(lvl, keep):
    """The level for the lanes ``keep``: its scales, or its stacked eta."""
    idx = solver._to_device(np.asarray(keep), lvl.ops[0].device)

    def take(t):
        return None if t is None else t.index_select(0, idx)

    def take_ops(ops):
        if ops is None or ops[0].dim() != 4:
            return ops
        return (*(c.index_select(0, idx) for c in ops[:3]), *ops[3:])

    return dataclasses.replace(
        lvl, ops=take_ops(lvl.ops), ops64=take_ops(lvl.ops64),
        scale=take(lvl.scale), scale64=take(lvl.scale64))


class _SelectedHierarchies:
    """Lane-sliced view of a hierarchy cache (the lanes ``keep``)."""

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
# task, split over the chunks like the fields) and every vector operation
# is batched over the task axis.  The vectors are complex128/float64, as
# in ``solver.krylov``; the preconditioner runs in the working precision.
# Per-task convergence is an ``active`` mask that freezes a task's x once
# its residual passes the tolerance; guarded divisions make
# post-breakdown algebra inert (zeros) instead of NaN.
# --------------------------------------------------------------------------

def _bdot(a, b):
    """Per-task conjugated inner product over field tuples -> (B,).

    Every task's sum is reduced on its own: a reduction over a task axis
    may split its work by the axis' width, and a lane's Krylov scalars,
    so its field, would then depend on how many lanes share its chunk
    (the task mesh reproduces the unsharded batch bit for bit).
    """
    return torch.stack([
        sum(torch.vdot(x[k].reshape(-1), y[k].reshape(-1))
            for x, y in zip(a, b)) for k in range(a[0].shape[0])])


def _bnorm_dev(a):
    """Per-task l2 norm over field tuples -> (B,) real (reduced task by
    task, as in :func:`_bdot`)."""
    return torch.sqrt(torch.stack([
        sum(torch.sum(torch.abs(x[k]) ** 2) for x in a)
        for k in range(a[0].shape[0])]))


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


def _bprecond(s, var, lanes):
    """Apply ``var.maxit`` batched MG cycles to s from a zero guess.

    Batched counterpart of the per-task preconditioner (``mg_precond``
    in ``solver.krylov``): split-precision accumulation inside, sc/lr
    direction cycling shared with the outer loop via ``var``, every
    chunk cycled once per cycle.  Runs a fixed cycle count (per-task
    early exit would desynchronize the batch); the count is the small
    ``maxcycle`` (e.g. 3) the reference also uses as its inner budget.
    """
    r = [tuple(c.to(lanes.dtypes[0]) for c in sc) for sc in s]
    e_hi = [tuple(torch.zeros_like(c) for c in rc) for rc in r]
    e_lo = [tuple(torch.zeros_like(c) for c in rc) for rc in r]
    for cyc in range(var.maxit):
        sc_next, lr_next = solver._next_dirs(var)
        chunks = lanes.get(var.sc_dir, var.lr_dir)
        with tracing.span('emg3d.cycle.step', replayed=False):
            for c, (meta, levels) in enumerate(chunks):
                de = solver._cycle_correction(meta, levels, r[c], var,
                                              cyc == 0)
                solver._accumulate_(e_hi[c], e_lo[c], de)
            var.sc_dir, var.lr_dir = sc_next, lr_next
            var.it += 1
            if cyc + 1 < var.maxit:
                r = [solver._residual_norm_split(
                    e_hi[c], e_lo[c], s[c], levels[0], per_task=True)[0]
                    for c, (_, levels) in enumerate(chunks)]
    hdt = s[0][0].dtype
    return [tuple(h.to(hdt) + lo.to(hdt) for h, lo in zip(eh, el))
            for eh, el in zip(e_hi, e_lo)]


def _restore_lanes(x, lanes, stash, ntask):
    """The full batch as host arrays from the batched field ``x`` of
    ``lanes`` and the ``stash`` ({task: tuple of host arrays}) of the
    lanes a shrink dropped."""
    parts = _from_lanes(x)
    if lanes.tasks.size == ntask and not stash:
        return parts
    out = dict(stash)
    for lane, task in enumerate(lanes.tasks):
        out[int(task)] = tuple(c[lane] for c in parts)
    return tuple(np.stack([out[k][j] for k in range(ntask)])
                 for j in range(3))


def _stash(stash, x, lanes, keep, hdt=None, lo=None):
    """Stash the host fields of the lanes a shrink drops (``x`` and, for
    a split iterate, ``lo``, combined in ``hdt``)."""
    for lane in np.setdiff1d(np.arange(lanes.tasks.size), keep):
        field = lanes.lane(x, lane)
        if lo is not None:
            field = tuple(h.to(hdt) + low.to(hdt) for h, low in
                          zip(field, lanes.lane(lo, lane)))
        with tracing.span('emg3d.fields.to_host'):
            stash[int(lanes.tasks[lane])] = tuple(solver._to_host(c)
                                                  for c in field)


def _bicgstab_batch(s, var, lanes, verb=0, x0=None):
    """Right-preconditioned BiCGSTAB over the task batch.

    Batched counterpart of ``solver._bicgstab`` (reference role:
    emg3d/solver.py:759-765); ``s`` (and ``x0``, which warm-starts the
    iteration: the initial residual is then s - A x0) are batched fields
    of ``lanes``.  Returns (x as host arrays over all tasks, rnorm, it,
    converged_mask).
    """
    arrs0 = [levels[0] for _, levels in lanes.get(var.sc_dir, var.lr_dir)]
    nchunk = len(lanes.devices)

    bnrm = lanes.host([_bnorm_dev(sc) for sc in s])
    atol = np.maximum(1e-30, var.tol * np.where(bnrm == 0, 1.0, bnrm))
    ones = lanes.split(np.ones(bnrm.shape), s[0][0].dtype)

    if x0 is None:
        x = [tuple(torch.zeros_like(c) for c in sc) for sc in s]
        r = s                        # r = s - A·0
        rnorm = bnrm.copy()
    else:
        x = x0
        r = [_bxpay(s[c], -ones[c], _bamat(x[c], arrs0[c]))
             for c in range(nchunk)]
        rnorm = lanes.host([_bnorm_dev(rc) for rc in r])
    rhat = r
    rho = alpha = omega = ones
    v = p = [tuple(torch.zeros_like(c) for c in sc) for sc in s]

    # Zero-source (or already-converged warm-started) tasks: born done.
    active = (bnrm > 0) & (rnorm >= atol)
    if not active.any():
        return _from_lanes(x), rnorm, 0, rnorm < atol

    # Lane bookkeeping for active shrink: ``lanes.tasks[lane]`` is the
    # original task held by lane ``lane``; dropped (converged) tasks'
    # solutions are stashed at shrink time.
    ntask = active.size
    stash = {}
    shrink = _shrink_on()

    it = 0
    for it in range(1, var.ssl_maxit + 1):
        cur = lanes.tasks
        p, rho = zip(*(_bcg_direction(r[c], rhat[c], p[c], v[c], rho[c],
                                      alpha[c], omega[c], first=it == 1)
                       for c in range(nchunk)))
        phat = _bprecond(p, var, lanes) if var.cycle else p
        v, alpha, svec = zip(*(_bcg_alpha(phat[c], r[c], rhat[c], rho[c],
                                          arrs0[c]) for c in range(nchunk)))
        shat = _bprecond(svec, var, lanes) if var.cycle else svec
        act = lanes.split(active[cur])
        x, r, omega, rnorm_dev = zip(*(_bcg_advance(
            shat[c], phat[c], svec[c], x[c], alpha[c], act[c], arrs0[c])
            for c in range(nchunk)))

        rnorm[cur] = np.where(active[cur], lanes.host(rnorm_dev),
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
            new_n = _shrink_size(cur.size, int(active[cur].sum()), nchunk)
            if new_n < cur.size:
                keep = _keep_lanes(active[cur], new_n)
                _stash(stash, x, lanes, keep)
                new = lanes.select(keep)
                x, r, rhat, v, p = (lanes.take(f, keep, new)
                                    for f in (x, r, rhat, v, p))
                rho, alpha, omega = (lanes.take(f, keep, new)
                                     for f in (rho, alpha, omega))
                lanes = new
                arrs0 = [levels[0] for _, levels in
                         lanes.get(var.sc_dir, var.lr_dir)]
                if verb > 3:
                    print(f"   ssl it {it:3}: batch shrunk to "
                          f"{lanes.tasks.size}/{ntask} lanes")

    return _restore_lanes(x, lanes, stash, ntask), rnorm, it, rnorm < atol


def _multigrid_batch(s, x0, var, lanes, l2_refe, verb=0):
    """Stand-alone multigrid cycles over the task batch.

    Batched counterpart of ``solver.multigrid``: the split iterate
    ``e_hi + e_lo`` in working precision, the per-task residual in
    double precision; a task is finished once converged or diverged, and
    the batch cycles until every task is.  ``s`` and ``x0`` are batched
    fields of ``lanes``.  Returns (x as host arrays in double precision
    over all tasks, per-task norms, cycles, exit messages).
    """
    e_hi = (x0 if x0 is not None
            else [tuple(torch.zeros_like(c) for c in sc) for sc in s])
    e_lo = [tuple(torch.zeros_like(c) for c in eh) for eh in e_hi]
    hdt = lanes.get(var.sc_dir, var.lr_dir)[0][1][0].ops64[0].dtype
    ntask = lanes.tasks.size

    # Active-shrink bookkeeping (see _shrink_size): ``lanes.tasks[lane]``
    # is the original task on lane ``lane``; finished tasks recompacted
    # away are stashed with their combined field and exit message.
    stash = {}
    l2_full = np.zeros(ntask)
    exit_full = ["MAX. ITERATION REACHED, NOT CONVERGED"] * ntask
    shrink = _shrink_on()

    it = 0
    first = True
    while True:
        chunks = lanes.get(var.sc_dir, var.lr_dir)
        r, l2_dev = zip(*(solver._residual_norm_split(
            e_hi[c], e_lo[c], s[c], levels[0], per_task=True)
            for c, (_, levels) in enumerate(chunks)))
        l2 = lanes.host(l2_dev)
        cur = lanes.tasks
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
            new_n = _shrink_size(cur.size, int((~finished).sum()),
                                 len(lanes.devices))
            if new_n < cur.size:
                keep = _keep_lanes(~finished, new_n)
                _stash(stash, e_hi, lanes, keep, hdt, e_lo)
                for lane in np.setdiff1d(np.arange(cur.size), keep):
                    exit_full[int(cur[lane])] = (
                        "CONVERGED" if done[lane] else "DIVERGED")
                new = lanes.select(keep)
                e_hi, e_lo, s, r = (lanes.take(f, keep, new)
                                    for f in (e_hi, e_lo, s, r))
                lanes = new
                chunks = lanes.get(var.sc_dir, var.lr_dir)
                if verb > 3:
                    print(f"   cycle {it:3}: batch shrunk to "
                          f"{lanes.tasks.size}/{ntask} lanes")

        sc_next, lr_next = solver._next_dirs(var)
        with tracing.span('emg3d.cycle.step', replayed=False):
            for c, (meta, levels) in enumerate(chunks):
                de = solver._cycle_correction(meta, levels, r[c], var,
                                              first)
                solver._accumulate_(e_hi[c], e_lo[c], de)
        first = False
        var.sc_dir, var.lr_dir = sc_next, lr_next
        it += 1

    # Combine the split field in double precision so that the algebraic
    # accuracy survives the export.
    x = [tuple(h.to(hdt) + lo.to(hdt) for h, lo in zip(eh, el))
         for eh, el in zip(e_hi, e_lo)]
    return _restore_lanes(x, lanes, stash, ntask), l2_full, it, exit_full


def solve_batch(model, sources, frequencies, mesh=None, axis="task",
                verb=0, **kwargs):
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
    mesh : DeviceGrid, optional
        A 1-D device mesh (:func:`make_task_mesh`); the task axis is split
        over its ``axis``, the batch padded up to a multiple of the mesh
        size.  ``device`` is then the mesh's first device (the default).
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
    return solve_batch_fields(model, sfields, mesh=mesh, axis=axis,
                              verb=verb, **kwargs)


def _mesh_devices(mesh, axis, kwargs):
    """The devices of the chunks; sets ``kwargs['device']`` to the
    first."""
    if mesh is None:
        return None
    if mesh.axis_names != (axis,):
        raise ValueError(f"The task mesh must be 1-D over {axis!r}; got "
                         f"axes {mesh.axis_names}.")
    devices = list(mesh.devices.flat)
    device = kwargs.get("device")
    if device is not None and domain.device_list(
            devices=[device])[0] != devices[0]:
        raise ValueError(f"device={device}, but the mesh's first device "
                         f"is {devices[0]}.")
    kwargs["device"] = devices[0]
    return devices


def solve_batch_fields(model, sfields, mesh=None, axis="task", verb=0,
                       efields=None, **kwargs):
    """Batched solve for prebuilt source fields (one per task).

    Engine behind :func:`solve_batch`; also the batch-mode carrier of
    the Simulation's adjoint (residual source fields, ``_bcompute``)
    and sensitivity (``jvec``) solves, whose right-hand sides are
    arbitrary fields rather than dipole sources (reference
    emg3d/simulations.py:1193-1233, 1270-1397).

    ``efields`` (list of Field or None, per task) warm-starts each
    task; already-converged guesses terminate with zero iterations.
    ``mesh``/``axis``: as in :func:`solve_batch`.  The call is the root
    span ``emg3d.batch.solve`` (``emg3d_tpu_torch.tracing``).
    """
    with tracing.span('emg3d.batch.solve', lanes=len(sfields)):
        return _solve_batch_fields(model, sfields, mesh, axis, verb,
                                   efields, **kwargs)


def _solve_batch_fields(model, sfields, mesh, axis, verb, efields,
                        **kwargs):
    t0 = time.perf_counter()
    nsrc = len(sfields)

    kwargs.setdefault("sslsolver", False)
    kwargs.setdefault("semicoarsening", False)
    kwargs.setdefault("linerelaxation", False)
    devices = _mesh_devices(mesh, axis, kwargs)
    var = solver.MGParameters(
        shape_cells=model.shape, verb=verb, **kwargs)
    if var.sslsolver and var.sslsolver != 'bicgstab':
        raise ValueError(
            f"sslsolver='{var.sslsolver}' has no batched form; use "
            "'bicgstab' (or parallel='task').")
    if devices is None:
        devices = [var.device]

    sfields = list(sfields)
    guesses = list(efields) if efields is not None else None
    if guesses is not None and not any(g is not None for g in guesses):
        guesses = None

    # Pad the batch to a multiple of the mesh size with copies of the
    # last task; the padding is dropped on output.
    pad = (-nsrc) % len(devices)
    sfields += [sfields[-1]] * pad
    if guesses is not None:
        guesses += [guesses[-1]] * pad
    ntask = nsrc + pad

    # Shared-eta layout: all tasks see the SAME model, and without
    # epsilon_r eta is linear in s: task k's eta is (s_k/s_0) times
    # task 0's, at every hierarchy level (restriction is linear).  One
    # eta copy + a (B,) scale vector then replaces the stacked etas; the
    # chunks of one device share it.
    if model.epsilon_r is None:
        vm0 = models.VolumeModel(model, sfields[0])
        scales = [sf.smu0 / sfields[0].smu0 for sf in sfields]
        bases = {}

        def make_hier(tasks, device):
            if device not in bases:
                bases[device] = _BatchHierarchies([vm0], var, scales,
                                                  device)
            if np.array_equal(tasks, np.arange(ntask)):
                return bases[device]
            return _SelectedHierarchies(bases[device], tasks)
        host_model = vm0
    else:
        vmodels = [models.VolumeModel(model, sf) for sf in sfields]

        def make_hier(tasks, device):
            return _BatchHierarchies([vmodels[t] for t in tasks], var,
                                     None, device)
        host_model = vmodels[0]
    lanes = _Lanes(devices, np.arange(ntask), make_hier)

    # The Krylov vectors are double precision (as in solver.krylov);
    # stand-alone multigrid keeps its source in working precision.
    dt = (solver._host_dtypes(host_model)[0] if var.sslsolver
          else lanes.dtypes[0])

    def stacked(per_task):
        # Staged as host tensors of ``dt``; _to_lanes copies them over.
        with tracing.span('emg3d.fields.to_device'):
            return _to_lanes(lanes, [
                tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dt)
                      for c in (f.fx, f.fy, f.fz)) for f in per_task])

    s = stacked(sfields)

    # Warm-start stack: per-task initial guesses (zeros where absent).
    x0 = None
    if guesses is not None:
        x0 = stacked([fields.Field(model.grid, dtype=sf.field.dtype,
                                   frequency=sf._frequency)
                      if g is None else g
                      for g, sf in zip(guesses, sfields)])

    l2_refe = np.array([np.linalg.norm(sf.field) for sf in sfields])
    l2_refe = np.where(l2_refe == 0.0, 1.0, l2_refe)

    if var.sslsolver:
        x, l2, it_ssl, conv = _bicgstab_batch(s, var, lanes, verb=verb,
                                              x0=x0)
        exit_messages = ["CONVERGED" if c else
                         "MAX. ITERATION REACHED, NOT CONVERGED"
                         for c in conv]
        it_mg = var.it
    else:
        x, l2, it_mg, exit_messages = _multigrid_batch(
            s, x0, var, lanes, l2_refe, verb=verb)
        it_ssl = 0

    # Unstack into Fields (drop the padding).
    out = []
    with tracing.span('emg3d.fields.to_host'):
        for i, sf in enumerate(sfields[:nsrc]):
            f = fields.Field(model.grid, dtype=sf.field.dtype,
                             frequency=sf._frequency)
            f.fx, f.fy, f.fz = (c[i] for c in x)
            out.append(f)

    info = {
        "it_mg": it_mg,
        "it_ssl": it_ssl,
        "abs_error": l2[:nsrc],
        "rel_error": (l2 / l2_refe)[:nsrc],
        "ref_error": l2_refe[:nsrc],
        "exit_messages": exit_messages[:nsrc],
        "tol": var.tol,
        # Wall clock of the whole batch (tasks run fused, there is no
        # meaningful per-task split).
        "runtime": round(time.perf_counter() - t0, 3),
    }
    return out, info
