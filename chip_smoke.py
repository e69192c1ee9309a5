"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one card, imports nothing of JAX.
Phases (any failure raises, and the script exits non-zero):

1. Card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
2. Build: both kernels from ``emg3d_tpu_torch/csrc`` (``gs_phase`` and
   ``line_phase``), one ``nvcc`` each, started together; nvcc seconds
   and the ``-Xptxas -v`` registers and spills of every instantiation.
   Then, before any kernel check, a new process whose first launches are
   its first solve: the 32^3 triaxial problem with the default solver,
   every cycle a whole-cycle CUDA graph (``EMG3D_TPU_CYCLE_JIT`` unset,
   so ``auto``); it must converge with captures and replays.
3. The level shapes of the main paths (6 and 18 below) and of the
   multi-grid survey (20: one grid of each shape, with and without shape
   classes), read from the hierarchies the solver builds for them: every
   level whose effective line-relaxation direction is 0 runs
   ``gs_phase``, every other level ``line_phase`` along the axes that
   direction names.  The Laplace path (18) runs the real
   instantiations, the others the complex ones.
4. ``gs_phase`` against its plain PyTorch version on the card, on every
   ``gs_phase`` shape of the complex main paths and a stretched odd
   shape in complex128 (to 1e-12) and complex64 (to 1e-5), and on every
   ``gs_phase`` shape of the Laplace path and the odd shape in float64
   (to 1e-12) and float32 (to 1e-5), norm-wise on the changed entries;
   all colors and one full sweep; per-phase times at 128^3 and 64^3.
5. ``line_phase`` against its plain PyTorch version on the card: axes 0,
   1 and 2 on every level shape of the default solve's three 128^3
   semicoarsening hierarchies (sc_dir 1, 2, 3) and on (37, 50, 29), and
   every other ``line_phase`` shape of the main paths along the axes the
   path relaxes there; every color and one forward-plus-reverse sweep,
   complex128 to 1e-12 and complex64 to 1e-6, four times the error
   measured, so that a lost digit shows; the same in float64 and
   float32, to the same tolerances, on the Laplace path's level shapes
   (all three axes) and the odd shape; and every colour, complex128 and
   complex64, on the level shapes only the multi-grid survey gives (20),
   along the axes it relaxes there.
   The plain version is bound by its host (some 16,000 launches per
   phase), so the shapes are shared out over worker processes, started
   once every timed kernel phase is done (the per-phase times of 4, 5
   and 11) and running beside the later phases; the script waits for
   them at its end.  Per-phase times at 128^3 and 64^3, with the host
   time of the wrapper alone, are taken before (the plain version's at
   128^3 along axis 0 only).
6. The main paths (``emg3d_tpu_torch.northstar``), each driven through
   ``emg3d_tpu_torch.solve`` with both launch counts set to 0 just
   before it and read just after:
   a. the BASELINE recipe (1 Ohm m fullspace, x-directed dipole at the
      origin, 1 Hz, 50 m cells, plain F-cycles to tol 1e-6) at 128^3;
   b. the default solver (MG-preconditioned BiCGSTAB, semicoarsening
      cycling 1-2-3, line relaxation cycling 4-5-6) on the 128^3
      triaxial fullspace (50 m cells, rho 1/2/5 Ohm m, x-dipole at the
      origin, 1 Hz), with no device and no solver options;
   c. semicoarsening and line-relaxation F-cycles on the 128 x 128 x 64
      marine model (water, stretched sediments, resistive target).
   Each must converge below 1e-6 through the kernels of its path, with
   no call of a plain version on CUDA.  Each is solved four times in a
   row (``CYCLE_RUNS``): three times with whole-cycle CUDA graphs (the
   default; the third under ``torch.profiler``), then operation by
   operation (``EMG3D_TPU_CYCLE_JIT=0``); wall time, cells/s,
   iterations, captures and replays, launches and peak memory of each.
   The graph solves must equal the per-operation one: iterations and
   exit message, fields to 1e-12 relative in norm (bit for bit
   expected).  The second and third capture nothing and launch nothing
   through the kernels' wrappers (every smoothing phase runs inside a
   replay); the kernels the third runs on the card, counted by the
   profiler, equal the per-operation solve's launches.  The launches in
   the kernels' record are the per-operation solve's.
7. Card against CPU in complex128: the default solve of a 16^3
   stretched triaxial grid (same it_ssl, it_mg and exit message, fields
   to 1e-10) and plain F-cycles on a 32^3 stretched grid (same cycles,
   fields to 1e-10).

8. The survey path (``northstar.salt_survey(128, 8)``: the salt-class
   model on 128^3 cells, 8 sources, 24 receivers, 1 Hz) through
   ``emg3d_tpu_torch.Simulation`` with no device given, both launch
   counts set to 0 just before and read just after: synthetic data with
   seeded noise as observed data; on a model with the salt's resistivity
   times 0.8 the misfit and the adjoint-state gradient (8 forward and 8
   adjoint solves); ``jvec`` of a box inside the salt (8 solves).  Every
   task must converge below 1e-6 with the default solver through both
   kernels with no plain call on CUDA; data, misfit, gradient and
   ``jvec`` finite, the gradient not zero and, in the layers that cut
   the salt, largest at its flank (with respect to conductivity:
   inside it).  Every solve runs on whole-cycle graphs, from an empty
   step cache, as in a new process; the captures and replays of the
   phase are printed, and its launch counts are those through the
   wrappers (the first use of each step and the launches recorded at
   its capture; replays do not pass through the wrappers).
9. Adjointness on the card: <w, Re(J v)> against <v, J^T w> on a 32^3
   stretched triaxial ``LgResistivity`` survey of 2 sources x 2
   frequencies, ``tol`` and ``tol_gradient`` 1e-9 in the card's default
   working precision (complex64 multigrid under complex128 Krylov
   vectors), to ADJOINT_RTOL.
10. Card against CPU in complex128 on a 16^3 survey of two sources with
    electric and magnetic receivers: synthetic data, misfit and gradient
    to 1e-8 of the largest entry, the same iterations per task, and
    ``get_magnetic_field`` to 1e-12.  Then ``Simulation.to_file`` and
    ``from_file`` as ``.npz`` and ``.json``: fields and data equal.

The batch engine (``emg3d_tpu_torch.parallel.batch``):

11. Both kernels with a task index (run right after phase 5): one
    batched launch against single launches task by task, 8 tasks on
    every shape of phases 4 and 5 and 3 on (37, 50, 29), every colour
    and every axis checked there, complex128 and complex64: with a
    stacked eta and with a shared eta whose scales are all 1 bit for
    bit; with random scales against single launches on ``scale[k] *
    eta`` built by PyTorch, to 1e-13 (complex128) and 1e-6 (complex64)
    on the changed entries.  The plain twins with a task axis against
    the kernels on (37, 50, 29).  Device ms of one batched phase at 128^3
    x 8 tasks beside 8 single phases, one on each task's tensors, and the
    batched phase's bound (the shared eta counted once).
12. ``solve_batch_fields`` of the 128^3 triaxial problem's source at
    0.25, 0.5, 1 and 2 Hz as one batch (BiCGSTAB, semicoarsening and
    line relaxation, tol 1e-6; eta scales other than 1), both launch
    counts set to 0 just before and read just after: every lane below
    1e-6 through both kernels, no plain call on CUDA; each lane beside
    the port's single solve.  Then 16^3 card against CPU in complex128:
    the same iterations and fields to 1e-10.
13. ``[multi-device]``, on the mesh entries E: every distinct card of the
    host if it has four or more, else ``['cuda:0'] * 4`` (one card drives
    the same code path as several).  Counts set to 0 just before each
    run and read just after.  The 128^3 triaxial default solve on a 2 x 2
    grid mesh over E (``solve(..., mesh=)``), held against phase 6's
    per-operation solve: the same exit message, ``it_ssl`` and ``it_mg``,
    fields within 1e-5 relative in norm; its level plan and the bytes of
    each piece of level 0 (about 26.6 % of the level each); the same for
    the 128^3 BASELINE plain F-cycles (``gs_phase`` only).  Then phase
    12's ``solve_batch`` (4 frequencies, 128^3) over 2 entries of E and
    over 3 (the batch padded to 6 lanes), each lane held against phase
    12's unsharded batch to 1e-12 with the same iterations; peak memory
    per device.  Last ``parallel.dryrun_multichip(len(E), devices=E)``.
    Both kernels launched on pieces, no plain call on CUDA.
14. The salt survey through both engines at 64^3 (4 sources, so 4
    lanes), on one set of observed data: at tol 1e-9 in complex128 the
    synthetic data, misfit, gradient and ``jvec`` of ``parallel='batch'``
    equal those of ``parallel='task'`` to 1e-5; at tol 1e-6 the batch
    lies from that answer no further than four times the task loop does
    (the witness that tol 1e-6 fixes these quantities only to some
    1e-2).  Then the salt survey of phase 8 through
    ``Simulation(parallel='batch')`` (one batch of 8 lanes per solve
    stage), counts set to 0 just before and read just after: forward,
    misfit and gradient on phase 8's observed data, ``jvec``; every lane
    below 1e-6 through both kernels, held against phase 8's results of
    the same run: data to 1e-4, misfit, gradient and ``jvec`` to
    ``SURVEY_BATCH_LIMITS``.

The inversion (``emg3d_tpu_torch.inversion``):

15. ``inversion.native.minimize`` (L-BFGS-B, 3 iterations) of the salt
    survey at 64^3 with 4 sources through ``Simulation`` with no device,
    in ``LgResistivity``: observed data of the true model, start model
    with the salt 0.8 times as resistive.  Per evaluation the misfit, the
    iterations of every task, seconds, captures and replays, from an
    empty step cache.  Every solve converges below 1e-6, the misfit
    falls, the first evaluation captures and no later one does, replays
    are at least ten times the captures, and
    the first evaluation's misfit and gradient equal a per-operation
    evaluation (``EMG3D_TPU_CYCLE_JIT=0``) of the start model to 1e-10.

The command line, north-star configuration 5, the Laplace domain and
the examples:

16. ``python3 -m emg3d_tpu_torch -g`` in a process of its own, with a
    config that names no device (so the card): the salt survey of phase 8
    with its observed data and the model of weaker salt, written with
    ``io.save`` as ``.npz``.  Data, misfit and gradient of its output
    equal phase 8's to 1e-12 relative to the largest entry (same card and
    code: bit for bit expected); its wall time, the iterations of its
    solves (from its log file) and the launch counts of that process.
    Then ``--report`` and a dry run (``-d``) through ``python3 -m``, on a
    host without JAX or h5py.
17. ``northstar.time_domain(64)``: 128 plain F-cycle solves of a 1 Ohm m
    fullspace on one grid, from an empty step cache, counts set to 0
    just before and read just after; every solve below 1e-6 in the JAX
    recipe's cycles (give or take one), the transient at 900 m within
    ``TIME_DOMAIN_LIMIT`` of the JAX recipe's (``TIME_DOMAIN_REFERENCE``)
    relative to the closed form (tests/alternatives.fullspace_dipole_time)
    at all 13 times, and the error against the closed form over the
    filter's core printed beside tools/bench_time.py's limit 0.15;
    wall time, first and warm solves, captures and replays, peak memory.
    Then 16^3 on 4 frequencies, card against CPU in complex128 (same
    ``it_mg``, responses and transient to 1e-10).
18. A Laplace-domain solve (``northstar.laplace_problem(128)``, a main
    path: the triaxial model, source at frequency -1, real fields) with
    the default solver through ``drive_modes`` as in phase 6: float32 on the
    card, every kernel run of the profiled solve a float32
    instantiation, steps captured of its own; then 32^3 in float64, card
    against CPU to 1e-10.
19. The three ``examples/torch_*.py`` as processes of their own on the
    card, started together: each exits 0 and prints its result.

A survey on automatically built grids, and the Krylov variants:

20. ``salt_128_frequency_gridding``: the salt model of phase 8 on its
    128^3 grid, 2 x-directed sources (x = -1500 and 1500 m), 6 of the
    12 receivers of the line y = +500 m, 6 frequencies from 0.05 to 12 Hz,
    ``gridding='frequency'`` with ``GRIDDING_OPTS`` (every chosen option
    and grid shape printed), the default solver to tol 1e-6.  First one
    solve on the largest grid alone (its peak memory); then the task
    loop on whole-cycle graphs, shape classes off, from an empty step
    cache, and the batch engine with shape classes (growth 1.35), each
    ``compute`` (seeded noise) and then ``misfit`` and ``gradient``, the
    counts set to 0 just before each engine and read just after.  Every
    task converges below 1e-6; stage times, solves, the share outside
    them, ``it_ssl``/``it_mg`` per task and grid shape, captures and
    replays; the running peak after each grid's first and last task (a
    grid's tasks follow each other), which may grow by
    ``MEMORY_GROWTH`` at most over a grid's tasks and from the forward
    stage to the gradient stage; the step cache's states and level
    stores are those its steps hold.  Then at the small recipe of
    tests/test_simulations.py::TestAutoGridding (0.5, 1 and 2 Hz),
    shape classes off and at 1.7: the batch engine against the task loop
    on the card (default solver, tol 1e-10) and the card against the CPU
    (plain V-cycles, tol 1e-6, the same ``it_mg``; the CPU side in two
    worker processes during the survey), data, misfit and gradient to
    1e-8 of the largest entry.
21. ``[krylov variants]`` (right after phase 6): the 128^3 triaxial
    problem with ``sslsolver='cgs'`` and ``'gcrotmk'``, each solved
    twice on graphs from an empty step cache, beside phase 6's warm
    BiCGSTAB; then the 16^3 stretched triaxial grid in complex128, card
    against CPU (the same ``it_ssl`` and ``it_mg``, fields to 1e-10).

Memory:

22. ``[memory repeat]`` (right after phase 12): with Python's collector
    off for the whole phase, five per-operation default solves of the
    128^3 triaxial problem (``EMG3D_TPU_CYCLE_JIT=0``), then two calls of
    phase 12's batch; memory_allocated and max_memory_allocated after
    each call.  From the first call to the last memory_allocated grows
    by ``GARBAGE_LIMIT`` (16 MiB) at most, each kind's last call peaks
    within 1 % of its first, and the calls of a kind take the same
    iterations: what a call allocates is freed when it returns, without
    a collection.
23. ``[memory]``, after every phase: memory_allocated before and after
    ``gc.collect()``; no phase may leave more than ``GARBAGE_LIMIT`` to
    the collector (memory held in reference cycles).

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import gc
import importlib.util
import itertools
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import unittest.mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
KERNELS = {
    "gs_phase": {
        "source": "emg3d_tpu_torch/csrc/gs_phase.cu",
        "symbol": "gs_phase_kernel",
        "replaces": ("emg3d_tpu/ops/pallas_gs.py:452 "
                     "(gauss_seidel_phase_pallas); "
                     "emg3d_tpu/ops/pallas_gs.py:663 "
                     "(gauss_seidel_phase_pallas_tiled)")},
    "line_phase": {
        "source": "emg3d_tpu_torch/csrc/line_phase.cu",
        "symbol": "line_phase_kernel",
        "replaces": ("none (XLA lax.scan line phase, "
                     "emg3d_tpu/ops/smoothers.py:791-850)")},
}

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): device
# memory, and float32 outside the tensor cores (complex64 arithmetic).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Real operations per phase node (gs_phase: assemble and eliminate the
# 6x6 complex system) and per line group (line_phase: assemble the 5x5
# blocks, eliminate, invert C_g, substitute back), counted from the
# kernels' arithmetic and rounded up.
GS_FLOPS_PER_NODE = 1200
LINE_FLOPS_PER_GROUP = 2000


def log(*args):
    print(*args, flush=True)


def check(cond, what=None):
    """Raise (also under ``python -O``) unless ``cond`` holds."""
    if not cond:
        raise RuntimeError(f"check failed: {what!r}")


def rel_err(a, b):
    """Norm-wise relative difference ||a - b|| / ||b||."""
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def path_levels(problem, options):
    """Where a solve of ``problem`` with ``options`` runs each kernel.

    Read from the hierarchies the solver builds (``solver._Hierarchies``,
    built here on the CPU; only each level's shape and effective
    line-relaxation direction are used), for every (sc_dir, lr_dir) pair
    the solve cycles through.  Returns (every level shape, the shapes of
    ``gs_phase``, {shape: axes} of ``line_phase``).
    """
    from emg3d_tpu_torch import models, solver

    model, sfield = problem
    opts = dict(sslsolver=True, semicoarsening=True, linerelaxation=True)
    opts.update(options)
    if opts.pop("plain", False):
        opts = {k: (False if v is True else v) for k, v in opts.items()}
    var = solver.MGParameters(verb=0, shape_cells=model.shape,
                              device="cpu", **opts)
    hier = solver._Hierarchies(models.VolumeModel(model, sfield), var)
    sc, lr = var.raw_sc_cycle, var.raw_lr_cycle
    shapes, gs, line = set(), set(), {}
    for k in range(int(np.lcm(len(sc), len(lr)))):
        meta, _ = hier.get(sc[k % len(sc)], lr[k % len(lr)])
        for shape, c_lr_dir, _ in meta:
            shapes.add(shape)
            if c_lr_dir == 0:
                gs.add(shape)
            for axis, dirs in solver.LINE_AXES:
                if c_lr_dir in dirs:
                    line.setdefault(shape, set()).add(axis)
    return shapes, gs, line


def phase_path_levels(problems, gridding_problems):
    """The kernels' shapes on the main paths and on the multi-grid survey
    (``gridding_problems``: {label: problem} on each grid shape of
    ``salt_128_frequency_gridding``, the default solver), to hold against
    the plain versions: ({shape} of ``gs_phase``, {shape: axes} of
    ``line_phase``) for the complex instantiations, and the same for the
    real ones (the Laplace-domain path); last the {shape: axes} of
    ``line_phase`` that only the multi-grid survey gives (checked colour
    by colour, without the sweeps).  The odd shape (37, 50, 29) is in the
    first four."""
    from emg3d_tpu_torch import northstar

    odd = (37, 50, 29)
    gs, line = {odd}, {odd: {0, 1, 2}}
    real_gs, real_line = {odd}, {odd: {0, 1, 2}}
    gridding_line = {}
    for case, problem in problems.items():
        shapes, p_gs, p_line = path_levels(
            problem, northstar.SOLVE_OPTIONS[case])
        log(f"[levels] {case} {problem[0].shape}: gs_phase on "
            f"{sorted(p_gs)}; line_phase on "
            f"{sorted((s, sorted(a)) for s, a in p_line.items())}")
        c_gs, c_line = ((real_gs, real_line) if case == "laplace"
                        else (gs, line))
        c_gs |= p_gs
        for shape, axes in p_line.items():
            c_line.setdefault(shape, set()).update(axes)
        if case in ("triaxial", "laplace"):
            # Every level shape of the default solve: all three axes.
            for shape in shapes:
                c_line.setdefault(shape, set()).update((0, 1, 2))
    for label, problem in gridding_problems.items():
        _, p_gs, p_line = path_levels(problem, {})
        log(f"[levels] salt_128_frequency_gridding {label} "
            f"{problem[0].shape}: gs_phase on {sorted(p_gs)}; line_phase on "
            f"{sorted((s, sorted(a)) for s, a in p_line.items())}")
        gs |= p_gs
        for shape, axes in p_line.items():
            gridding_line.setdefault(shape, set()).update(axes)
    gridding_line = {s: a - line.get(s, set())
                     for s, a in gridding_line.items()}
    gridding_line = {s: a for s, a in gridding_line.items() if a}
    check(gs and line and len(real_gs) > 1 and len(real_line) > 1
          and gridding_line, "no kernel on the main paths")
    bysize = dict(key=lambda s: (-int(np.prod(s)), s))
    return (*(
        (sorted(g, **bysize), {s: sorted(ln[s]) for s in sorted(ln, **bysize)})
        for g, ln in ((gs, line), (real_gs, real_line))),
        {s: sorted(gridding_line[s]) for s in sorted(gridding_line,
                                                     **bysize)})


def operands(shape, dtype, rdt, seed):
    """Random phase operands from a numpy seed, on the card."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    edges = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
             (nx + 1, ny + 1, nz)]
    cell = (nx, ny, nz)

    def dev(a, dt):
        return torch.from_numpy(a).to(device="cuda", dtype=dt)

    def val(s, lo=-1.0, hi=1.0, im=(-1.0, 1.0)):
        a = rng.uniform(lo, hi, s)
        if dtype.is_complex:
            a = a + 1j * rng.uniform(*im, s)
        return dev(a, dtype)

    # eta is scaled so that its diagonal term and the curl-curl terms
    # (~4 zeta / h^2) are of one size: neither dominates the systems.
    e = [val(s) for s in edges]
    s = [val(s) for s in edges]
    eta = [val(cell, -5.0, -1.0, (1.0, 5.0)) for _ in range(3)]
    zeta = dev(rng.uniform(1e3, 2e3, cell), rdt)
    h = [dev(rng.uniform(20.0, 60.0, n), rdt) for n in shape]
    return [*e, *s, *eta, zeta, *h]


def updated_err(out, ref, base):
    """Norm-wise relative difference of the entries the phase changed.

    Returns (max over ex/ey/ez of ||a - b|| / ||b||, max |a - b|), both
    taken only where the plain version changed the input.
    """
    rel, mabs = 0.0, 0.0
    for a, b, c in zip(out[:3], ref[:3], base[:3]):
        mask = b != c
        if mask.any():
            rel = max(rel, rel_err(a[mask], b[mask]))
            mabs = max(mabs, float((a[mask] - b[mask]).abs().max()))
    return rel, mabs


def bound_ms(nbytes, flops):
    """(least ms of the card for the work, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gs_phase_work(shape, color, item, ritem, tasks=1):
    """(bytes, flops) one point phase must move and do.

    Counted once each: the neighbouring edges the phase nodes read (12
    per node, shared between nodes), the 6 edges per node written and
    their sources read, the 8 cells around each node (3 eta of ``item``
    bytes, zeta of ``ritem``), and the widths.  ``tasks`` > 1: the
    batched phase on a shared eta with a per-task scale (the layout
    ``time_batched`` times): edges and sources per task, eta, zeta and
    the widths once, and the scales.
    """
    nx, ny, nz = (len(range(1 + p, n, 2)) for n, p in zip(shape, color))
    nodes = nx * ny * nz
    read = (2 * nx * ((ny + 1) * nz + ny * (nz + 1))
            + 2 * ny * ((nx + 1) * nz + nx * (nz + 1))
            + 2 * nz * ((nx + 1) * ny + nx * (ny + 1)))
    cells = 8 * nodes
    scales = tasks if tasks > 1 else 0
    nbytes = (item * (tasks * (read + 2 * 6 * nodes) + 3 * cells + scales)
              + ritem * (cells + sum(shape)))
    return nbytes, tasks * GS_FLOPS_PER_NODE * nodes


def line_phase_work(shape, color, axis, item, ritem, tasks=1):
    """(bytes, flops, scratch bytes) of one line phase.

    Counted once each, in the frame of the lines (x along the line): the
    neighbouring edges the lines read, the 5 NX - 4 unknowns per line
    written and their sources read, the cells around the lines (3 eta
    of ``item`` bytes, zeta of ``ritem``) and the widths.  The block-
    Thomas scratch (``line_phase.SCRATCH_VALUES`` values per group,
    written and read back) is returned apart.  ``tasks``: as in
    ``gs_phase_work``.
    """
    from emg3d_tpu_torch.ops import line_phase

    NX, NY, NZ = (shape[i] for i in line_phase.FRAMES[axis])
    ncy, ncz = (NY - color[0]) // 2, (NZ - color[1]) // 2
    lines = ncy * ncz
    written = lines * (5 * NX - 4)
    read = (NX * ((ncy + 1) * ncz + ncy * (ncz + 1))
            + (NX - 1) * 2 * ncy * (ncz + 1)
            + (NX - 1) * (ncy + 1) * 2 * ncz)
    cells = NX * 2 * ncy * 2 * ncz
    scales = tasks if tasks > 1 else 0
    nbytes = (item * (tasks * (read + 2 * written) + 3 * cells + scales)
              + ritem * (cells + NX + NY + NZ))
    scratch = 2 * item * line_phase.SCRATCH_VALUES * lines * (NX - 1)
    return nbytes, tasks * LINE_FLOPS_PER_GROUP * lines * NX, tasks * scratch


def phase_card():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi}")
    log(f"[card] torch: {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {name}; count {torch.cuda.device_count()}")
    return smi, name


def phase_build():
    import emg3d_tpu_torch
    from emg3d_tpu_torch.ops import _build

    pkg = pathlib.Path(emg3d_tpu_torch.__file__).resolve().parent
    check(pkg.parent == ROOT, f"emg3d_tpu_torch imported from {pkg}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))
    log(f"[build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f}"
        f" s wall, flags {' '.join(_build.NVCC_FLAGS)}")
    for name in KERNELS:
        log(f"[build] {name}.cu: nvcc "
            f"{_build.BUILD_SECONDS.get(name, 0.0):.2f} s; ptxas:\n"
            f"{_build.PTXAS_INFO.get(name, '(reused build)')}")


def host_ms(fn, reps=200):
    """Mean host ms of ``fn()``: ``reps`` calls timed together with no
    synchronisation between them (what the caller's thread pays)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / reps


def time_phase(fn, args, color, reps):
    """(ms per call on the stream, ms of device kernel time per call).

    The first is CUDA-event time over ``reps`` back-to-back calls after a
    warm-up, host dispatch gaps included; the second sums the device time
    of every kernel the calls launched, from ``torch.profiler`` (None if
    the profiler recorded no device activity).
    """
    fn(*args, *color)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args, *color)
    stop.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(stop) / reps

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args, *color)
        torch.cuda.synchronize()
    kernel_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    device_ms = kernel_us / 1e3 / reps if kernel_us > 0 else None
    return event_ms, device_ms


# The instantiations the phase checks hold against the plain versions:
# (working dtype, real dtype, tolerance of the norm-wise error of the
# changed entries) for gs_phase and line_phase.
GS_CASES = {"complex": [(torch.complex128, torch.float64, 1e-12),
                        (torch.complex64, torch.float32, 1e-5)],
            "real": [(torch.float64, torch.float64, 1e-12),
                     (torch.float32, torch.float32, 1e-5)]}
LINE_CASES = {"complex": [(torch.complex128, torch.float64, 1e-12),
                          (torch.complex64, torch.float32, 1e-6)],
              "real": [(torch.float64, torch.float64, 1e-12),
                       (torch.float32, torch.float32, 1e-6)]}
# The single-precision instantiations, whose largest absolute error the
# kernels' record reports.
SINGLE = (torch.complex64, torch.float32)


def phase_gs_vs_plain(shapes, real_shapes):
    """Hold ``gs_phase`` against its plain version, every colour and two
    full sweeps, in complex128/complex64 on ``shapes`` and in
    float64/float32 on ``real_shapes``.  Returns (the largest absolute
    error in single precision, (kernel, plain) ms of one 128^3 phase,
    (bound ms, what bounds it))."""
    from emg3d_tpu_torch.ops import smoothers

    plain = smoothers._gauss_seidel_phase_torch
    kernel = smoothers.gauss_seidel_phase
    log(f"[gs_phase] {len(shapes)} shapes complex, {len(real_shapes)} "
        f"real: {shapes}; {real_shapes}")
    worst = {}
    max_abs = 0.0
    jobs = ([(s, "complex") for s in shapes]
            + [(s, "real") for s in real_shapes])
    for shape, kind in jobs:
        for dtype, rdt, tol in GS_CASES[kind]:
            base = operands(shape, dtype, rdt, seed=sum(shape))
            for color in smoothers.phase_colors(shape, False):
                ref = [t.clone() for t in base]
                out = [t.clone() for t in base]
                plain(*ref, *color)
                kernel(*out, *color)
                torch.cuda.synchronize()
                err, mabs = updated_err(out, ref, base)
                check(err <= tol, (shape, dtype, color, err))
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
                if dtype in SINGLE:
                    max_abs = max(max_abs, mabs)
            # Two full sweeps: the phases in order, then reversed.
            ref = [t.clone() for t in base]
            out = [t.clone() for t in base]
            for reverse in (False, True):
                for color in smoothers.phase_colors(shape, reverse):
                    plain(*ref, *color)
                    kernel(*out, *color)
            torch.cuda.synchronize()
            err, _ = updated_err(out, ref, base)
            check(err <= tol, (shape, dtype, "sweep", err))
        log(f"[gs_phase] {shape} {kind}: all colors + sweep agree (worst so "
            f"far {({k: f'{v:.2e}' for k, v in worst.items()})})")

    times = {}
    for n in (128, 64):
        args = operands((n, n, n), torch.complex64, torch.float32, seed=n)
        k_ev, k_dev = time_phase(kernel, args, (0, 0, 0), 50)
        p_ev, p_dev = time_phase(plain, args, (0, 0, 0), 10)
        times[n] = (k_dev or k_ev, p_dev or p_ev)
        nbytes, flops = gs_phase_work((n, n, n), (0, 0, 0), 8, 4)
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"[gs_phase] phase time {n}^3 complex64 (ms per phase): kernel "
            f"{k_ev!r} on the stream, {k_dev!r} device; plain {p_ev!r} on "
            f"the stream, {p_dev!r} device; bound {b_ms!r} ({b_by}: "
            f"{nbytes} B, {flops} flop)")
        if n == 128:
            bound = (b_ms, b_by)
    return max_abs, times[128], bound


def _line_compare(plain, kernel, base, steps, tol, what):
    """Run ``steps`` ((p1, p2, axis) phases) with the plain version and
    the kernel on copies of the fields; check the changed entries."""
    ref = [t.clone() for t in base[:3]] + base[3:]
    out = [t.clone() for t in base[:3]] + base[3:]
    for step in steps:
        plain(*ref, *step)
        kernel(*out, *step)
    torch.cuda.synchronize()
    err, mabs = updated_err(out, ref, base)
    check(err <= tol, (what, err))
    # Entries no phase changed stay bit-identical.
    for a, b, c in zip(out[:3], ref[:3], base[:3]):
        keep = b == c
        check(torch.equal(a[keep], c[keep]), (what, "untouched entries"))
    return err, mabs


# Worker processes of the line checks: each worker's plain version keeps
# one core busy issuing launches, and its CUDA runtime threads and the
# parent want the rest of the 8 cores of a one-card host.  Measured on
# such a host with an H100: the 36 complex shapes took 340 s in one
# process, 89-96 s in 4 workers and 80.6 s in 6; with the 20 real jobs
# of the Laplace path, 117.9 s in 6; with the 85 colour-by-colour jobs
# of the multi-grid survey the phase took 214.7-307.3 s in 6 (since
# then the checks run beside the later phases).
LINE_WORKERS = 6


def line_check_shapes(jobs):
    """Hold ``line_phase`` against its plain version, every colour and,
    where ``sweep``, two full sweeps per axis, on ``jobs`` ([(shape, axes,
    "complex" or "real", sweep)], the dtypes of ``LINE_CASES``); runs in
    a worker process or in the caller's.  Returns ({dtype name: worst
    norm-wise error}, the largest absolute error in single precision)."""
    from emg3d_tpu_torch.ops import smoothers

    plain = smoothers._line_relax_phase_torch
    kernel = smoothers.gauss_seidel_line_phase
    colors = smoothers.line_phase_colors
    worst = {}
    max_abs = 0.0
    t0 = time.perf_counter()
    for shape, axes, kind, sweep in jobs:
        for dtype, rdt, tol in LINE_CASES[kind]:
            base = operands(shape, dtype, rdt, seed=sum(shape) + 1)
            for axis in axes:
                for color in colors(shape, axis, False):
                    err, mabs = _line_compare(
                        plain, kernel, base, [(*color, axis)], tol,
                        (shape, dtype, axis, color))
                    worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
                    if dtype in SINGLE:
                        max_abs = max(max_abs, mabs)
                if sweep:
                    steps = [(*c, axis) for rev in (False, True)
                             for c in colors(shape, axis, rev)]
                    err, _ = _line_compare(plain, kernel, base, steps, tol,
                                           (shape, dtype, axis, "sweep"))
                    worst[str(dtype)] = max(worst[str(dtype)], err)
        log(f"[line_phase] {shape} {kind} axes {axes}: all colors "
            f"{'and sweeps ' if sweep else ''}agree (worst of this worker "
            f"so far "
            f"{({k: f'{v:.2e}' for k, v in worst.items()})}; "
            f"{time.perf_counter() - t0:.1f} s)")
    return worst, max_abs


def start_line_checks(shapes, real_shapes, colour_shapes):
    """Start holding ``line_phase`` against its plain version in
    ``LINE_WORKERS`` worker processes, which run beside the later phases
    (the plain version is bound by its host, the card has room):
    ``shapes``, ``real_shapes``: {shape: the axes to check there} in
    complex128/complex64 and in float64/float32, every colour and two
    sweeps; ``colour_shapes``: the same in complex128/complex64, every
    colour (the multi-grid survey's level shapes: the sweeps run the same
    phases in turn, held on the other shapes, and would take three times
    as long).  Returns the handle ``finish_line_checks`` takes."""
    import multiprocessing

    log(f"[line_phase] {len(shapes)} shapes complex, {len(real_shapes)} "
        f"real, {len(colour_shapes)} complex colour by colour: "
        f"{[(s, a) for s, a in shapes.items()]}; "
        f"{[(s, a) for s, a in real_shapes.items()]}; "
        f"{[(s, a) for s, a in colour_shapes.items()]}")
    # Deal the jobs (largest first) round the workers: the cost of the
    # plain version follows the length and number of a shape's lines.
    jobs = sorted([(s, a, "complex", True) for s, a in shapes.items()]
                  + [(s, a, "real", True) for s, a in real_shapes.items()]
                  + [(s, a, "complex", False)
                     for s, a in colour_shapes.items()],
                  key=lambda j: (-int(np.prod(j[0])) * len(j[1])
                                 * (3 if j[3] else 1), j[2], j[0]))
    pool = concurrent.futures.ProcessPoolExecutor(
        LINE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    futures = [pool.submit(line_check_shapes, jobs[i::LINE_WORKERS])
               for i in range(LINE_WORKERS)]
    return pool, futures, len(jobs), time.perf_counter()


def finish_line_checks(handle):
    """Wait for ``start_line_checks``'s workers and end them; check that
    every job agreed.  Returns the largest absolute error in single
    precision."""
    pool, futures, njobs, t0 = handle
    with pool:
        results = [f.result() for f in futures]
    worst = {k: max(r[0].get(k, 0.0) for r in results)
             for k in set().union(*(r[0] for r in results))}
    log(f"[line_phase] all {njobs} jobs agree: worst "
        f"{({k: f'{v:.2e}' for k, v in sorted(worst.items())})} "
        f"({LINE_WORKERS} worker processes, {time.perf_counter() - t0:.1f} "
        f"s from their start)")
    check(len(worst) == 4, worst)
    return max(r[1] for r in results)


def line_phase_times():
    """Per-phase times of ``line_phase`` at 128^3 and 64^3, every axis,
    with the wrapper's host time, and of its plain version at 128^3 along
    axis 0 (some 16,000 launches a phase: profiling it takes seconds per
    shape and axis, so it is timed where the kernels' record reads it).
    Returns ((kernel, plain) ms of one 128^3 phase along axis 0, (bound
    ms, what bounds it))."""
    from emg3d_tpu_torch.ops import smoothers

    plain = smoothers._line_relax_phase_torch
    kernel = smoothers.gauss_seidel_line_phase
    times, bound = {}, None
    for n in (128, 64):
        args = operands((n, n, n), torch.complex64, torch.float32, seed=n)
        for axis in (0, 1, 2):
            k_ev, k_dev = time_phase(kernel, args, (0, 0, axis), 50)
            k_host = host_ms(lambda: kernel(*args, 0, 0, axis))
            p_ev = p_dev = None
            if n == 128 and axis == 0:
                p_ev, p_dev = time_phase(plain, args, (0, 0, axis), 2)
            nbytes, flops, scratch = line_phase_work(
                (n, n, n), (0, 0), axis, 8, 4)
            b_ms, b_by = bound_ms(nbytes, flops)
            log(f"[line_phase] phase time {n}^3 complex64 axis {axis} (ms "
                f"per phase): kernel {k_ev!r} on the stream, {k_dev!r} "
                f"device, {k_host!r} host time of the wrapper alone; plain "
                f"{p_ev!r} on the stream, {p_dev!r} device (None: not "
                f"timed); "
                f"bound {b_ms!r} ({b_by}: {nbytes} B, {flops} flop; "
                f"scratch apart {scratch} B)")
            if n == 128 and axis == 0:
                times = (k_dev or k_ev, p_dev or p_ev)
                bound = (b_ms, b_by)
    return times, bound


# ---------------------------------------------------------------------------
# The task index of both kernels (the batch engine).
# ---------------------------------------------------------------------------

def batched_operands(shape, ntask, dtype, rdt, seed):
    """Random operands of ``ntask`` tasks on the card, from a torch seed:
    (fields, sources, stacked eta, shared eta, zeta and widths, per-task
    eta scales).  The fields and sources carry the task axis; the shared
    eta is task 0's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nx, ny, nz = shape
    edges = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
             (nx + 1, ny + 1, nz)]

    def uni(s, lo, hi):
        return torch.empty(s, dtype=rdt, device="cuda").uniform_(
            lo, hi, generator=gen)

    def val(s, lo=-1.0, hi=1.0, im=(-1.0, 1.0)):
        re = uni(s, lo, hi)
        return torch.complex(re, uni(s, *im)) if dtype.is_complex else re

    # eta of the size of the curl-curl terms, as in ``operands``.
    e = [val((ntask, *c)) for c in edges]
    src = [val((ntask, *c)) for c in edges]
    eta = [val((ntask, *shape), -5.0, -1.0, (1.0, 5.0)) for _ in range(3)]
    rest = [uni(shape, 1e3, 2e3), *(uni((n,), 20.0, 60.0) for n in shape)]
    scale = val((ntask,), 0.5, 2.0)
    return e, src, eta, [c[0] for c in eta], rest, scale


def batched_vs_single(kernel, ops, step, tol):
    """One phase of ``kernel`` launched once for every task against
    single launches task by task, in three layouts: stacked eta and
    shared eta with every scale 1, bit for bit; shared eta with the
    random scales against single launches on ``scale[k] * eta`` built by
    PyTorch, norm-wise to ``tol`` on the changed entries.  Returns that
    error and its largest absolute error."""
    e, src, stacked, shared, rest, scale = ops
    layouts = (
        ("stacked", stacked, None, lambda k: [c[k] for c in stacked]),
        ("scale 1", shared, torch.ones_like(scale), lambda k: shared),
        ("scale", shared, scale, lambda k: [scale[k] * c for c in shared]))
    for name, eta, sc, eta_of in layouts:
        out = [c.clone() for c in e]
        kernel(*out, *src, *eta, *rest, *step, scale=sc)
        ref = [c.clone() for c in e]
        for k in range(e[0].shape[0]):
            kernel(*(c[k] for c in ref), *(c[k] for c in src), *eta_of(k),
                   *rest, *step)
        torch.cuda.synchronize()
        if sc is None or name == "scale 1":
            check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                  (name, step, "batched launch differs from single ones"))
        else:
            err, mabs = updated_err(out, ref, e)
            check(err <= tol, (name, step, err))
    return err, mabs


BATCH = 8           # tasks per batched launch at the main paths' shapes
ODD = (37, 50, 29)  # and 3 tasks on this stretched odd shape


def phase_batched_kernels(gs_shapes, line_shapes):
    """Both kernels with a task index: batched launches against single
    launches on every shape of the kernel checks (every colour, every
    axis checked there), the plain batched twins on the odd shape, and
    per-phase times at 128^3.  Returns {kernel: (the timing record, the
    largest absolute error in complex64)}."""
    from emg3d_tpu_torch.ops import smoothers

    kernels = {"gs_phase": smoothers.gauss_seidel_phase,
               "line_phase": smoothers.gauss_seidel_line_phase}
    steps = {
        "gs_phase": {s: smoothers.phase_colors(s, False) for s in gs_shapes},
        "line_phase": {
            s: [(*c, axis) for axis in axes
                for c in smoothers.line_phase_colors(s, axis, False)]
            for s, axes in line_shapes.items()}}
    cases = [(torch.complex128, torch.float64, 1e-13),
             (torch.complex64, torch.float32, 1e-6)]
    out = {}
    for name, kernel in kernels.items():
        t0 = time.perf_counter()
        worst = {str(c[0]): 0.0 for c in cases}
        max_abs_c64 = 0.0
        for shape, shape_steps in steps[name].items():
            ntask = 3 if shape == ODD else BATCH
            for dtype, rdt, tol in cases:
                ops = batched_operands(shape, ntask, dtype, rdt,
                                       seed=sum(shape) + 2)
                for step in shape_steps:
                    err, mabs = batched_vs_single(kernel, ops, step, tol)
                    worst[str(dtype)] = max(worst[str(dtype)], err)
                    if dtype == torch.complex64:
                        max_abs_c64 = max(max_abs_c64, mabs)
                del ops
        log(f"[batched] {name}: {len(steps[name])} shapes ({BATCH} tasks, 3 "
            f"on {ODD}), every colour and axis: stacked eta and scale 1 "
            f"bit for bit equal to single launches; random scales worst "
            f"{worst} against single launches on scale * eta "
            f"({time.perf_counter() - t0:.1f} s)")
        out[name] = [None, max_abs_c64]

    # The plain twins with a task axis (task by task) on the odd shape.
    plain = {"gs_phase": (smoothers._gauss_seidel_phase_torch, 1e-12, 1e-5),
             "line_phase": (smoothers._line_relax_phase_torch, 1e-12, 1e-6)}
    odd_steps = {"gs_phase": smoothers.phase_colors(ODD, False),
                 "line_phase": [(*c, a) for a in (0, 1, 2)
                                for c in smoothers.line_phase_colors(
                                    ODD, a, False)]}
    for name, (twin, tol128, tol64) in plain.items():
        errs = []
        for dtype, rdt, tol in ((torch.complex128, torch.float64, tol128),
                                (torch.complex64, torch.float32, tol64)):
            e, src, _, shared, rest, scale = batched_operands(
                ODD, 3, dtype, rdt, seed=11)
            for step in odd_steps[name]:
                a = [c.clone() for c in e]
                b = [c.clone() for c in e]
                kernels[name](*a, *src, *shared, *rest, *step, scale=scale)
                twin(*b, *src, *shared, *rest, *step, scale=scale)
                torch.cuda.synchronize()
                err, _ = updated_err(a, b, e)
                check(err <= tol, (name, "plain twin", dtype, step, err))
                errs.append(err)
        log(f"[batched] {name} against its plain twin with a task axis, "
            f"{ODD} x 3 tasks, random scales, every colour and axis: worst "
            f"{max(errs):.2e}")

    for name, rec in time_batched(kernels).items():
        out[name][0] = rec
    return out


def queued_ms(fn, args, step, reps):
    """Device ms per call of ``fn(*args, *step)``: ``reps`` calls queued
    behind a spin kernel, between two CUDA events, so that the events
    bracket device work alone and no host gap between the launches."""
    fn(*args, *step)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)      # some 25 ms: the host queues all
    start.record()
    for _ in range(reps):
        fn(*args, *step)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_batched(kernels, n=128):
    """Device ms of one batched phase (color 0, axis 0) at ``n``^3 in
    complex64 with ``BATCH`` tasks on a shared eta with random scales and
    on a stacked eta (no scale), beside ``BATCH`` single phases, one on
    each task's own tensors (task k's eta ``scale[k] * eta``), and the
    bound of the batched phase on the shared eta."""
    work = {"gs_phase": gs_phase_work((n, n, n), (0, 0, 0), 8, 4, BATCH),
            "line_phase": line_phase_work((n, n, n), (0, 0), 0, 8, 4,
                                          BATCH)}
    step = {"gs_phase": (0, 0, 0), "line_phase": (0, 0, 0)}
    out = {}
    for name, kernel in kernels.items():
        e, src, stacked, shared, rest, scale = batched_operands(
            (n, n, n), BATCH, torch.complex64, torch.float32, seed=n)
        batched = queued_ms(lambda *a: kernel(*a, scale=scale),
                            [*e, *src, *shared, *rest], step[name], 10)
        unscaled = queued_ms(kernel, [*e, *src, *stacked, *rest], step[name],
                             10)
        tasks = [[*(c[k] for c in e), *(c[k] for c in src),
                  *(scale[k] * c for c in shared), *rest]
                 for k in range(BATCH)]
        # 40 launches, 5 per task in turn: no launch finds the tensors of
        # the one before it in L2.
        turn = itertools.cycle(tasks)
        single = queued_ms(lambda *st: kernel(*next(turn), *st), [],
                           step[name], 5 * BATCH)
        nbytes, flops = work[name][:2]
        b_ms, b_by = bound_ms(nbytes, flops)
        rec = {"tasks": BATCH, "ms": batched, "stacked_ms": unscaled,
               "single_ms_times_tasks": BATCH * single,
               "bound_ms": b_ms, "bound_by": b_by}
        scratch = (f"; scratch apart {work[name][2]} B"
                   if len(work[name]) > 2 else "")
        log(f"[batched] {name} phase time {n}^3 complex64 x {BATCH} tasks, "
            f"device ms per phase (queued launches between events): "
            f"batched {batched!r} (stacked eta, no scale: {unscaled!r}); "
            f"single, each on its own task's tensors, "
            f"{single!r}, x {BATCH} = {BATCH * single!r}; bound {b_ms!r} "
            f"({b_by}: {nbytes} B, {flops} flop: edges and sources per "
            f"task, eta shared, once{scratch})")
        out[name] = rec
        del e, src, stacked, shared, rest, tasks, turn
    return out


def kernel_counts(reset=False):
    """{kernel: (launches, plain calls on CUDA)}; ``reset`` sets them to 0
    first."""
    from emg3d_tpu_torch.ops import gs_phase, line_phase

    mods = {"gs_phase": gs_phase, "line_phase": line_phase}
    if reset:
        for mod in mods.values():
            mod.reset_counts()
    return {k: (m.LAUNCHES, m.PLAIN_CALLS_ON_CUDA) for k, m in mods.items()}


def executed(prof):
    """({kernel: runs on the card}, {instantiation, e.g.
    ``gs_phase_kernel<float, float, false>``: runs on the card}) in a
    ``torch.profiler`` trace, for the kernels of ``KERNELS``, by symbol:
    launched one by one or replayed in a CUDA graph."""
    runs = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for v in KERNELS.values():
            i = e.name.find(v["symbol"] + "<")
            if i < 0:
                continue
            depth, j = 0, i + len(v["symbol"])
            for j in range(j, len(e.name)):
                depth += {"<": 1, ">": -1}.get(e.name[j], 0)
                if depth == 0:
                    break
            name = e.name[i:j + 1].replace("(anonymous namespace)::", "")
            runs[name] = runs.get(name, 0) + 1
    per_kernel = {k: sum(n for name, n in runs.items()
                         if name.startswith(v["symbol"] + "<"))
                  for k, v in KERNELS.items()}
    return per_kernel, runs


def drive(label, problem, kernels, profiled=False, **kw):
    """Solve ``problem`` through ``emg3d_tpu_torch.solve`` with every
    launch count and both whole-cycle counts set to 0 just before and read
    just after; check that it converged and called no plain version on
    CUDA.  With ``profiled`` the solve runs under ``torch.profiler``.
    Returns the run: {kernel: launches}, with ``profiled`` {kernel: runs
    on the card} and {instantiation: runs on the card}, the field, the
    info, seconds, peak memory, captures and replays."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from emg3d_tpu_torch import solve, solver

    model, sfield = problem
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    kernel_counts(reset=True)
    solver.reset_counts()
    prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        efield, info = solve(model, sfield, return_info=True, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = kernel_counts()
    per_kernel, per_instantiation = (executed(prof) if profiled
                                     else (None, None))
    run = {"launches": {k: c[0] for k, c in counts.items()},
           "executed": per_kernel, "instantiations": per_instantiation,
           "field": np.asarray(efield.field), "info": info, "seconds": dt,
           "peak": torch.cuda.max_memory_allocated(),
           "reserved": torch.cuda.max_memory_reserved(),
           "captures": solver.CYCLE_CAPTURES,
           "replays": solver.CYCLE_REPLAYS}
    cells = int(np.prod(model.shape))
    field = run["field"]
    log(f"[solve] {label} {model.shape}: {dt!r} s, {cells / dt:.0f} "
        f"cells/s, it_ssl {info['it_ssl']}, it_mg {info['it_mg']}, "
        f"rel_error {info['rel_error']!r}, {info['exit_message']}, "
        f"max_memory_allocated {run['peak']} B (reserved "
        f"{run['reserved']} B, the graphs' pool included; allocated at the "
        f"start {start} B), launches "
        f"through the wrappers {run['launches']}, plain calls on cuda "
        f"{({k: c[1] for k, c in counts.items()})}, cycle graphs: "
        f"{run['captures']} captures, {run['replays']} replays"
        + (f", kernels run on the card (profiler) {run['executed']}, by "
           f"instantiation {run['instantiations']}" if profiled else ""))
    check(info['exit'] == 0, (label, info['exit_message']))
    check(info['rel_error'] < 1e-6, (label, info['rel_error']))
    done = run["executed"] if profiled else run["launches"]
    if profiled or solver.CYCLE_CAPTURES or not solver.CYCLE_REPLAYS:
        for name in kernels:
            check(done[name] > 0, (label, name, "not launched"))
    check(all(c[1] == 0 for c in counts.values()), (label, counts))
    check(field.shape == (sfield.field.size,))
    check(np.all(np.isfinite(field)) and np.abs(field).max() > 0)
    return run


# The runs of every main path: three times with whole-cycle CUDA graphs
# (the default; the third under the profiler), then once operation by
# operation.
CYCLE_RUNS = (("graph", "auto"), ("graph again", "auto"),
              ("graph, profiled", "auto"), ("per-operation", "0"))


def drive_modes(label, problem, kernels, **kw):
    """``drive`` the path in each mode of ``CYCLE_RUNS``, in one process.
    The graph solves must equal the per-operation solve (iterations, exit
    message, fields to 1e-12 relative in norm); the second and third
    graph solves must capture nothing and launch nothing through the
    wrappers, and the kernels the third runs on the card (profiler) must
    equal the per-operation solve's launches.  Returns the runs, by the
    names of ``CYCLE_RUNS``."""
    runs = {}
    for run, mode in CYCLE_RUNS:
        os.environ["EMG3D_TPU_CYCLE_JIT"] = mode
        try:
            runs[run] = drive(f"{label} [{run}]", problem, kernels,
                              profiled=run == "graph, profiled", **kw)
        finally:
            del os.environ["EMG3D_TPU_CYCLE_JIT"]
    ref = runs["per-operation"]
    cells = int(np.prod(problem[0].shape))
    for run in ("graph", "graph again", "graph, profiled"):
        out = runs[run]
        diff = rel_err(torch.from_numpy(out["field"]),
                       torch.from_numpy(ref["field"]))
        log(f"[cycle graph] {label} [{run}] against [per-operation]: "
            f"{out['seconds']!r} s against {ref['seconds']!r} s "
            f"({ref['seconds'] / out['seconds']:.3f}x; "
            f"{cells / out['seconds']:.0f} against "
            f"{cells / ref['seconds']:.0f} cells/s), peak "
            f"{out['peak']} B against {ref['peak']} B (reserved "
            f"{out['reserved']} B against {ref['reserved']} B), fields' "
            f"largest difference "
            f"{float(np.abs(out['field'] - ref['field']).max())!r}"
            f" (relative in norm {diff!r}), bit for bit "
            f"{bool(np.array_equal(out['field'], ref['field']))}")
        for key in ("it_ssl", "it_mg", "exit_message"):
            check(out["info"][key] == ref["info"][key], (label, run, key))
        check(diff <= 1e-12, (label, run, diff))
        check(out["replays"] > 0, (label, run, "no replay"))
    for run in ("graph again", "graph, profiled"):
        out = runs[run]
        check(out["captures"] == 0, (label, run, "captured again"))
        check(not any(out["launches"].values()),
              (label, run, "launched outside a replay", out["launches"]))
    executed = runs["graph, profiled"]["executed"]
    log(f"[cycle graph] {label}: kernels run on the card by the replays "
        f"of the profiled graph solve {executed}, launches of the "
        f"per-operation solve {ref['launches']}")
    check(executed == ref["launches"], (label, executed, ref["launches"]))
    return runs


def main_problems():
    """The main paths' problems: {case: (model, sfield)}."""
    from emg3d_tpu_torch import northstar

    return {"baseline": northstar.baseline_problem(128),
            "triaxial": northstar.triaxial_problem(128),
            "marine": northstar.marine_problem(128),
            "laplace": northstar.laplace_problem(128)}


def phase_main_paths(problems):
    from emg3d_tpu_torch import northstar, solve

    opts = northstar.SOLVE_OPTIONS
    # Warm-up of both paths at a small size (first-call costs).
    solve(*northstar.baseline_problem(32), tol=1e-6, **opts["baseline"])
    solve(*northstar.triaxial_problem(32), tol=1e-6, **opts["triaxial"])
    paths = {
        "baseline_plain_128": drive_modes(
            "BASELINE plain F-cycles", problems["baseline"], ["gs_phase"],
            tol=1e-6, **opts["baseline"]),
        "triaxial_default_128": drive_modes(
            "triaxial default solver", problems["triaxial"],
            ["gs_phase", "line_phase"], tol=1e-6, **opts["triaxial"]),
        "marine_sclr_128x128x64": drive_modes(
            "marine sc+lr F-cycles", problems["marine"], ["line_phase"],
            tol=1e-6, **opts["marine"])}
    bicgstab = paths["triaxial_default_128"]["graph again"]
    refs = {k: v["per-operation"] for k, v in paths.items()}
    paths = {k: v["launches"] for k, v in refs.items()}
    check(paths["baseline_plain_128"]["line_phase"] == 0, paths)
    return paths, refs, bicgstab


def phase_fresh_graph_solve():
    """A new process whose first kernel launches are its first solve (the
    kernels are built, not yet loaded): the triaxial 32^3 problem with
    the default solver on the card, whole-cycle graphs on (``auto``), must
    converge with captures and replays."""
    code = ("import json\n"
            "from emg3d_tpu_torch import northstar, solve, solver\n"
            "ef, info = solve(*northstar.triaxial_problem(32), tol=1e-6,\n"
            "                 return_info=True)\n"
            "print(json.dumps({k: info[k] for k in ('exit', 'exit_message',"
            " 'it_ssl', 'it_mg', 'rel_error')} | {'captures': "
            "solver.CYCLE_CAPTURES, 'replays': solver.CYCLE_REPLAYS}))\n")
    env = {k: v for k, v in os.environ.items()
           if k != "EMG3D_TPU_CYCLE_JIT"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[fresh process] triaxial 32^3, default solver, graphs on: "
        f"{out} ({time.perf_counter() - t0:.1f} s with the start of the "
        f"process)")
    check(out["exit"] == 0 and out["rel_error"] < 1e-6, out)
    check(out["captures"] > 0 and out["replays"] > 0, out)


def stretched_triaxial(n, seed):
    from emg3d_tpu_torch import Model, TensorMesh, get_source_field

    rng = np.random.default_rng(seed)
    h = [rng.uniform(40.0, 120.0, n) for _ in range(3)]
    # Centred: the source stays well inside, off the PEC boundary edges.
    grid = TensorMesh(h, origin=tuple(-0.5 * x.sum() for x in h))
    shape = grid.shape_cells
    model = Model(grid, property_x=rng.uniform(1, 3, shape),
                  property_y=rng.uniform(1, 4, shape),
                  property_z=rng.uniform(2, 6, shape),
                  mapping='Resistivity')
    sfield = get_source_field(grid, (0., 0., 0., 20., 10.), 0.77)
    return model, sfield


def phase_card_vs_cpu():
    from emg3d_tpu_torch import solve

    for label, n, seed, kw in (
            ("default solver", 16, 16, {}),
            ("plain F-cycles", 32, 32, dict(plain=True, cycle='F'))):
        model, sfield = stretched_triaxial(n, seed)
        kw = dict(kw, tol=1e-6, return_info=True, dtype=torch.complex128)
        t0 = time.perf_counter()
        ef_gpu, inf_gpu = solve(model, sfield, device='cuda', **kw)
        t1 = time.perf_counter()
        ef_cpu, inf_cpu = solve(model, sfield, device='cpu', **kw)
        t2 = time.perf_counter()
        err = rel_err(torch.from_numpy(np.asarray(ef_gpu.field)),
                      torch.from_numpy(np.asarray(ef_cpu.field)))
        log(f"[parity] {n}^3 stretched triaxial complex128, {label}: card "
            f"it_ssl {inf_gpu['it_ssl']} it_mg {inf_gpu['it_mg']} "
            f"({t1 - t0:.2f} s), cpu it_ssl {inf_cpu['it_ssl']} it_mg "
            f"{inf_cpu['it_mg']} ({t2 - t1:.2f} s), field rel diff "
            f"{err:.2e}")
        check(inf_gpu['exit'] == 0 and inf_cpu['exit'] == 0, label)
        check(inf_gpu['exit_message'] == inf_cpu['exit_message'], label)
        check(inf_gpu['it_mg'] == inf_cpu['it_mg'], label)
        check(inf_gpu['it_ssl'] == inf_cpu['it_ssl'], label)
        check(err <= 1e-10, (label, err))


def check_tasks(sim, which, tol):
    """Every task of ``sim`` converged below ``tol``; returns the (it_ssl,
    it_mg) of the tasks."""
    its = []
    for src, freq in sim._srcfreq:
        info = sim._dict_get(f"{which}_info", src, freq)
        if info['exit'] != 0 or not info['rel_error'] < tol:
            log(f"[survey] {which} {src} {freq} did not converge: "
                f"{info['exit_message']}, rel_error {info['rel_error']!r}, "
                f"it_ssl {info['it_ssl']}, it_mg {info['it_mg']}, errors "
                f"{info.get('error_at_cycle')}\n{info.get('log')}")
        check(info['exit'] == 0, (which, src, freq, info['exit_message']))
        check(info['rel_error'] < tol, (which, src, freq, info['rel_error']))
        its.append((info['it_ssl'], info['it_mg']))
    return its


def phase_survey(n=128, nsrc=8):
    """The salt-class ``n``^3 survey of ``nsrc`` sources.  Returns
    {kernel: launches} of the whole phase and its results (synthetic
    and observed data, misfit, gradient, ``jvec``)."""
    from emg3d_tpu_torch import Simulation, northstar, solver, tracing

    survey, model, kw = northstar.salt_survey(n, nsrc)
    kw['tqdm_opts'] = False
    grid = model.grid
    cells = int(np.prod(model.shape))
    salt = northstar.salt_mask(grid)
    log(f"[survey] salt survey {model.shape}: {cells} cells, {nsrc} sources, "
        f"{survey.shape[1]} receivers, 1 Hz; salt {int(salt.sum())} cells "
        f"of {model.property_x[salt].max():.1f} Ohm m, sediments "
        f"{model.property_x[~salt].min():.2f}-"
        f"{model.property_x[~salt].max():.2f} Ohm m")

    solver._STEPS.clear()       # the survey captures its own steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    solver.reset_counts()
    stages = {}

    def stage(name, nsolves, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        tracing.clear()
        with tracing.recording():
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        inside = [r.seconds for r in tracing.roots()]
        check(len(inside) == nsolves, (name, len(inside), nsolves))
        stages[name] = (dt, sum(inside), torch.cuda.max_memory_allocated())
        log(f"[survey] {name}: {dt!r} s for {nsolves} solves, {dt / nsolves!r}"
            f" s per solve, {cells * nsolves / dt:.0f} cells x solves / s; "
            f"{sum(inside)!r} s inside solve (smallest {min(inside)!r}, "
            f"largest {max(inside)!r}), {100 * (1 - sum(inside) / dt):.1f} % "
            f"outside it; max_memory_allocated {stages[name][2]} B "
            f"(allocated at the stage's start {start} B)")
        return out

    # Forward: synthetic data, with seeded noise, become the observed data.
    sim = Simulation(survey, model, **kw)
    check(sim.device == 'cuda', sim.device)
    stage("forward", nsrc, lambda: sim.compute(
        observed=True, rng=np.random.default_rng(20)))
    its = check_tasks(sim, 'efield', 1e-6)
    synthetic = np.asarray(sim.data.synthetic).copy()
    observed = np.asarray(sim.data.observed)
    check(np.all(np.isfinite(np.asarray(sim.data.synthetic))), "synthetic")
    kept = np.isfinite(observed)
    check(kept.sum() > observed.size // 2, ("noise cut the data", kept.sum()))
    log(f"[survey] forward tasks: it_ssl {min(i[0] for i in its)}-"
        f"{max(i[0] for i in its)}, it_mg {min(i[1] for i in its)}-"
        f"{max(i[1] for i in its)}; {int(kept.sum())} of {observed.size} "
        f"data above half the noise floor and kept, |observed| "
        f"{np.nanmin(np.abs(observed)):.3e}-"
        f"{np.nanmax(np.abs(observed)):.3e}")

    # Misfit and gradient of a model whose salt is 0.8 times as resistive.
    sim2 = Simulation(sim.survey.copy(), northstar.salt_model(
        grid, salt_scale=0.8), **kw)
    del sim

    def misfit_and_gradient():
        return sim2.misfit, sim2.gradient

    misfit, grad = stage("misfit and gradient", 2 * nsrc,
                         misfit_and_gradient)
    synthetic_weak = np.asarray(sim2.data.synthetic).copy()
    its_f = check_tasks(sim2, 'efield', 1e-6)
    its_b = check_tasks(sim2, 'bfield', 1e-6)
    log(f"[survey] gradient tasks: forward it_ssl "
        f"{min(i[0] for i in its_f)}-{max(i[0] for i in its_f)}, it_mg "
        f"{min(i[1] for i in its_f)}-{max(i[1] for i in its_f)}; adjoint "
        f"it_ssl {min(i[0] for i in its_b)}-{max(i[0] for i in its_b)}, "
        f"it_mg {min(i[1] for i in its_b)}-{max(i[1] for i in its_b)}")
    check(np.isfinite(misfit) and misfit > 0, misfit)
    check(grad.shape == (n, n, n), grad.shape)
    check(np.all(np.isfinite(grad)) and np.abs(grad).max() > 0, "gradient")

    # Where the gradient is largest.  Overall it is at a source or a
    # receiver, and it falls off with depth, so the salt is looked for
    # layer by layer: in every layer of cells that cuts the salt, the
    # largest |gradient| must lie at the salt's flank, within 3 cells of
    # it (inside, the gradient with respect to resistivity carries the
    # factor 1 / rho^2 and is small); the gradient with respect to
    # conductivity, - rho^2 times it, must be largest inside the salt
    # below z = -1200 m, just above the salt's top.
    def argmax(a):
        return tuple(int(i) for i in np.unravel_index(
            np.argmax(np.abs(a)), a.shape))

    def xyz(i):
        return tuple(float(c[j]) for c, j in zip(
            (grid.cell_centers_x, grid.cell_centers_y, grid.cell_centers_z),
            i))

    def near_salt(i, reach=3):
        return bool(salt[tuple(slice(max(j - reach, 0), j + reach + 1)
                               for j in i)].any())

    i_all = argmax(grad)
    layers = [k for k in range(n) if salt[:, :, k].any()]
    at_flank = [near_salt((*argmax(grad[:, :, k]), k)) for k in layers]
    deep = grid.cell_centers_z < -1200.0
    gsigma = np.where(deep[None, None, :],
                      -sim2.model.property_x ** 2 * grad, 0.0)
    i_sig = argmax(gsigma)
    log(f"[survey] misfit {misfit!r}; |gradient| largest overall "
        f"{abs(grad[i_all])!r} at cell {i_all} {xyz(i_all)} m; in "
        f"{sum(at_flank)} of the {len(layers)} layers that cut the salt "
        f"(z = {grid.cell_centers_z[layers[0]]} to "
        f"{grid.cell_centers_z[layers[-1]]} m) the largest of the layer "
        f"lies within 3 cells of the salt; the gradient with respect to "
        f"conductivity below z = -1200 m is largest, {abs(gsigma[i_sig])!r}"
        f", at cell {i_sig} {xyz(i_sig)} m, in the salt: "
        f"{bool(salt[i_sig])}")
    check(len(layers) > 0 and sum(at_flank) >= 0.9 * len(layers),
          ("gradient largest away from the salt's flank", at_flank))
    check(bool(salt[i_sig]), ("conductivity gradient largest outside the "
                              "salt", i_sig))

    # jvec of a box in the middle of the salt.
    jvec = stage("jvec", nsrc, lambda: sim2.jvec(northstar.salt_box(grid)))
    check(jvec.shape == survey.shape, jvec.shape)
    check(np.all(np.isfinite(jvec)) and np.abs(jvec).max() > 0, "jvec")
    jvec = np.asarray(jvec)
    log(f"[survey] |jvec| largest {np.abs(jvec).max()!r}, relative to the "
        f"data there {np.nanmax(np.abs(jvec / observed))!r}")

    counts = kernel_counts()
    total, inside = (sum(s[i] for s in stages.values()) for i in (0, 1))
    nsolves = 4 * nsrc
    log(f"[survey] whole path: {total!r} s for {nsolves} solves "
        f"({total / nsolves!r} s per solve, {cells * nsolves / total:.0f} "
        f"cells x solves / s), {100 * (1 - inside / total):.1f} % outside "
        f"solve (forward pass alone "
        f"{100 * (1 - stages['forward'][1] / stages['forward'][0]):.1f} %); "
        f"max_memory_allocated {max(st[2] for st in stages.values())} B; "
        f"launches through the wrappers (first uses and captures; replays "
        f"do not pass through them) "
        f"{({k: c[0] for k, c in counts.items()})}, plain calls on cuda "
        f"{({k: c[1] for k, c in counts.items()})}; cycle graphs: "
        f"{solver.CYCLE_CAPTURES} captures, {solver.CYCLE_REPLAYS} "
        f"replays")
    for name, (launches, plain) in counts.items():
        check(launches > 0, (name, "not launched on the survey path"))
        check(plain == 0, (name, "plain calls on CUDA", plain))
    check(solver.CYCLE_REPLAYS > solver.CYCLE_CAPTURES, "survey replays")
    results = {"synthetic": synthetic, "observed": observed.copy(),
               "synthetic_weak": synthetic_weak,
               "misfit": misfit, "gradient": grad, "jvec": jvec}
    return {k: c[0] for k, c in counts.items()}, results


# The production configuration, given in full: the batch engine's
# defaults are plain multigrid.
PRODUCTION = {"sslsolver": True, "semicoarsening": True,
              "linerelaxation": True}


def phase_solve_batch(problems):
    """``solve_batch_fields`` at full width: the 128^3 triaxial problem's
    source at 0.25, 0.5, 1 and 2 Hz as one batch, with both launch counts
    set to 0 just before and read just after; every lane against the
    port's own single solve; then card against CPU in complex128 at 16^3.
    Returns {kernel: launches} of the batched solve."""
    from emg3d_tpu_torch import (get_source_field, northstar, solve,
                                 solve_batch_fields)

    freqs = [0.25, 0.5, 1.0, 2.0]
    model, _ = problems["triaxial"]
    sfields = [get_source_field(model.grid, (0., 0., 0., 0., 0.), f)
               for f in freqs]
    # Warm-up at a small size (first-call costs).
    small, _ = northstar.triaxial_problem(32)
    solve_batch_fields(small, [get_source_field(
        small.grid, (0., 0., 0., 0., 0.), f) for f in freqs[:2]],
        tol=1e-6, **PRODUCTION)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    efields, info = solve_batch_fields(model, sfields, tol=1e-6,
                                       **PRODUCTION)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    cells = int(np.prod(model.shape))
    log(f"[solve_batch] triaxial {model.shape} x {len(freqs)} frequencies "
        f"{freqs} Hz, one batch: {dt!r} s ({cells * len(freqs) / dt:.0f} "
        f"cells x tasks / s), it_ssl {info['it_ssl']}, it_mg "
        f"{info['it_mg']}, rel_error {list(info['rel_error'])}, "
        f"{info['exit_messages']}, max_memory_allocated {peak} B "
        f"({peak // len(freqs)} B per task), launches "
        f"{({k: c[0] for k, c in counts.items()})}, plain calls on cuda "
        f"{({k: c[1] for k, c in counts.items()})}")
    check(info['exit_messages'] == ['CONVERGED'] * len(freqs), info)
    check(np.all(info['rel_error'] < 1e-6), info['rel_error'])
    for name, (launches, plain) in counts.items():
        check(launches > 0, (name, "not launched by solve_batch"))
        check(plain == 0, (name, "plain calls on CUDA", plain))

    total = 0.0
    for f, sf, ef in zip(freqs, sfields, efields):
        check(np.all(np.isfinite(ef.field)) and np.abs(ef.field).max() > 0,
              f)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        single, inf = solve(model, sf, return_info=True, tol=1e-6)
        torch.cuda.synchronize()
        total += time.perf_counter() - t1
        diff = rel_err(torch.from_numpy(ef.field),
                       torch.from_numpy(single.field))
        log(f"[solve_batch] lane {f} Hz against its single solve: it_ssl "
            f"{inf['it_ssl']}, it_mg {inf['it_mg']}, rel_error "
            f"{inf['rel_error']!r}; fields' relative difference {diff:.3e}")
        check(inf['exit'] == 0 and diff < 1e-4, (f, diff))
    log(f"[solve_batch] the {len(freqs)} single solves: {total!r} s; the "
        f"batch {dt!r} s")

    # Card against CPU in complex128 at 16^3.
    small, _ = stretched_triaxial(16, 16)
    small_src = [get_source_field(small.grid, (0., 0., 0., 20., 10.), f)
                 for f in freqs[1:3]]
    runs = {}
    for device in ('cuda', 'cpu'):
        t1 = time.perf_counter()
        runs[device] = solve_batch_fields(
            small, small_src, device=device, tol=1e-6,
            dtype=torch.complex128, **PRODUCTION)
        runs[device] += (time.perf_counter() - t1,)
    (card, i_card, t_card), (cpu, i_cpu, t_cpu) = runs['cuda'], runs['cpu']
    err = max(rel_err(torch.from_numpy(a.field), torch.from_numpy(b.field))
              for a, b in zip(card, cpu))
    log(f"[solve_batch] 16^3 stretched triaxial x {len(small_src)} "
        f"frequencies, complex128: card it_ssl {i_card['it_ssl']} it_mg "
        f"{i_card['it_mg']} ({t_card:.2f} s), cpu it_ssl {i_cpu['it_ssl']} "
        f"it_mg {i_cpu['it_mg']} ({t_cpu:.2f} s); fields' largest relative "
        f"difference {err:.2e}")
    check((i_card['it_ssl'], i_card['it_mg']) == (i_cpu['it_ssl'],
                                                  i_cpu['it_mg']), "its")
    check(i_card['exit_messages'] == i_cpu['exit_messages']
          == ['CONVERGED'] * len(small_src), "exit")
    check(err <= 1e-10, err)
    return {k: c[0] for k, c in counts.items()}, (efields, info)


# What a phase may leave to Python's collector (memory_allocated before
# less after gc.collect()), and what ``[memory repeat]`` may grow by from
# its first call to its last with the collector off: a call of the port
# frees what it allocated when it returns.
GARBAGE_LIMIT = 16 * 2 ** 20
# ``[memory repeat]``: the last call of a kind peaks within this share of
# the first call of that kind.
REPEAT_PEAK_RTOL = 0.01


def phase_memory_repeat(problem, nsolves=5, nbatches=2):
    """``[memory repeat]``: with Python's collector off for the whole
    phase, ``nsolves`` per-operation default solves of ``problem`` (the
    128^3 triaxial problem, ``EMG3D_TPU_CYCLE_JIT=0``), then ``nbatches``
    ``solve_batch_fields`` calls of its source at 0.25, 0.5, 1 and 2 Hz
    (phase 12's batch).  After each call its memory_allocated and
    max_memory_allocated (reset just before it), printed as they come.
    From the first call to the last memory_allocated may grow by
    ``GARBAGE_LIMIT`` at most, the last call of each kind must peak
    within ``REPEAT_PEAK_RTOL`` of the first of its kind, and the calls
    of a kind take the same iterations."""
    from emg3d_tpu_torch import get_source_field, solve, solve_batch_fields

    model, sfield = problem
    freqs = [0.25, 0.5, 1.0, 2.0]
    sfields = [get_source_field(model.grid, (0., 0., 0., 0., 0.), f)
               for f in freqs]

    def single():
        _, info = solve(model, sfield, return_info=True, tol=1e-6)
        check(info["exit"] == 0, info["exit_message"])
        return info["it_ssl"], info["it_mg"]

    def batched():
        _, info = solve_batch_fields(model, sfields, tol=1e-6, **PRODUCTION)
        check(info["exit_messages"] == ["CONVERGED"] * len(freqs), info)
        return info["it_ssl"], info["it_mg"]

    calls = ([("solve", single)] * nsolves
             + [("solve_batch", batched)] * nbatches)
    rows = []
    os.environ["EMG3D_TPU_CYCLE_JIT"] = "0"
    gc.collect()
    gc.disable()
    try:
        log(f"[memory repeat] collector off; memory_allocated at the start "
            f"{torch.cuda.memory_allocated()} B")
        for i, (kind, call) in enumerate(calls):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            its = call()
            torch.cuda.synchronize()
            rows.append((kind, its, torch.cuda.memory_allocated(),
                         torch.cuda.max_memory_allocated()))
            log(f"[memory repeat] call {i + 1} ({kind}, "
                f"{time.perf_counter() - t0:.3f} s, it_ssl {its[0]}, it_mg "
                f"{its[1]}): memory_allocated {rows[-1][2]} B, "
                f"max_memory_allocated {rows[-1][3]} B")
    finally:
        gc.enable()
        del os.environ["EMG3D_TPU_CYCLE_JIT"]
    growth = rows[-1][2] - rows[0][2]
    peaks = {k: [r[3] for r in rows if r[0] == k] for k, _ in calls}
    log(f"[memory repeat] memory_allocated from the first call to the last "
        f"grew by {growth} B (limit {GARBAGE_LIMIT} B); peaks by kind "
        f"{peaks} B")
    check(growth <= GARBAGE_LIMIT, ("memory repeat growth", growth))
    for kind, p in peaks.items():
        check(abs(p[-1] - p[0]) <= REPEAT_PEAK_RTOL * p[0], (kind, p))
        check(len({r[1] for r in rows if r[0] == kind}) == 1, (kind, rows))


def mesh_entries():
    """E: every distinct card if the host has four or more, else
    ``cuda:0`` four times."""
    n = torch.cuda.device_count()
    if n >= 4:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * 4


def level_plan(problem, options, placement):
    """The grid-sharded hierarchies of a solve of ``problem``: {sc_dir:
    [(level shape, 'sharded' or 'replicated')]}, the bytes of each piece
    of level 0 beside the bytes of the whole level, and {line axis: per
    piece (operand bytes, field and source bytes)} of level 0's line
    layouts."""
    from emg3d_tpu_torch import models, solver
    from emg3d_tpu_torch.parallel import domain

    model, sfield = problem
    opts = dict(sslsolver=True, semicoarsening=True, linerelaxation=True)
    opts.update(options)
    if opts.pop("plain", False):
        opts = {k: (False if v is True else v) for k, v in opts.items()}
    var = solver.MGParameters(verb=0, shape_cells=model.shape,
                              device=placement.device, **opts)
    var.placement = placement
    hier = solver._Hierarchies(models.VolumeModel(model, sfield), var)
    plan = {}
    for sc in var.raw_sc_cycle:
        meta, levels = hier.get(sc, var.raw_lr_cycle[0])
        plan[int(sc)] = [(m[0], "sharded" if lvl.sharded else "replicated")
                         for m, lvl in zip(meta, levels)]
    lvl0 = levels[0]
    cdt, rdt = hier.dtypes
    whole = (int(np.prod(model.shape))
             * (3 * cdt.itemsize + rdt.itemsize)
             + sum(model.shape) * rdt.itemsize)
    # What the y- and z-lines of level 0 hold per piece on their line
    # layout: the level's operands there (kept) and the working copies of
    # the field and the source (for one smoothing call).
    lines = {}
    for axis in (1, 2):
        lay, blocks = lvl0._line(axis)
        lines[axis] = [
            (sum(t.numel() * t.element_size() for t in b.ops),
             2 * cdt.itemsize * sum(int(np.prod(lay.ext_shape(k, kind)))
                                    for kind in domain.EDGES))
            for k, b in enumerate(blocks)]
    return plan, lvl0.piece_bytes(), whole, lines


def phase_multi_device(problems, main_refs, batch_ref):
    """The ``[multi-device]`` phase: grid-sharded 128^3 default and
    BASELINE solves over a 2 x 2 mesh of the entries E, held against the
    per-operation solves of phase 6; the 128^3 x 4 frequencies batch over
    2 and 3 entries, held against phase 12's unsharded batch; the dry
    run.  Returns {path: {kernel: launches}}."""
    from emg3d_tpu_torch import (get_source_field, northstar,
                                 solve_batch_fields)
    from emg3d_tpu_torch.parallel import (domain, dryrun_multichip,
                                          make_grid_mesh, make_task_mesh)

    E = mesh_entries()
    cards = sorted({d.index for d in E})
    log(f"[multi-device] entries E = {[str(d) for d in E]} "
        f"({torch.cuda.device_count()} card(s) on the host); distinct "
        f"cards driven: {len(cards)}")
    opts = northstar.SOLVE_OPTIONS
    paths = {}

    def peaks():
        return {f"cuda:{i}": torch.cuda.max_memory_allocated(i)
                for i in cards}

    def reset_peaks():
        for i in cards:
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)

    for key, case, kernels, label in (
            ("grid_triaxial_default_128", "triaxial",
             ["gs_phase", "line_phase"], "triaxial default solver"),
            ("grid_baseline_plain_128", "baseline", ["gs_phase"],
             "BASELINE plain F-cycles")):
        placement = domain.GridPlacement(make_grid_mesh(devices=E))
        plan, pieces, whole, lines = level_plan(problems[case],
                                                opts[case], placement)
        log(f"[multi-device] {label}: mesh {placement.mesh.shape} over E; "
            f"level plan by sc_dir {plan}; level-0 piece bytes {pieces} "
            f"of {whole} B for the whole level "
            f"({[round(100 * p / whole, 2) for p in pieces]} %); on the "
            f"line layouts of level 0, per piece (operands kept, field "
            f"and source copied for a smoothing call) in B: y-lines "
            f"{lines[1]}, z-lines {lines[2]}")
        check(all(0.2 < p / whole < 0.3 for p in pieces), pieces)
        reset_peaks()
        run = drive(f"{label} [grid-sharded, 2 x 2 over E]",
                    problems[case], kernels, tol=1e-6, mesh=placement,
                    **opts[case])
        for i in cards:
            torch.cuda.synchronize(i)
        ref = main_refs[{"triaxial": "triaxial_default_128",
                         "baseline": "baseline_plain_128"}[case]]
        diff = rel_err(torch.from_numpy(run["field"]),
                       torch.from_numpy(ref["field"]))
        log(f"[multi-device] {label}: {run['seconds']!r} s sharded against "
            f"{ref['seconds']!r} s unsharded per operation; it_ssl "
            f"{run['info']['it_ssl']} / {ref['info']['it_ssl']}, it_mg "
            f"{run['info']['it_mg']} / {ref['info']['it_mg']}; fields' "
            f"relative difference in norm {diff!r} (bit for bit "
            f"{bool(np.array_equal(run['field'], ref['field']))}); launches "
            f"{run['launches']} against {ref['launches']}; peak per card "
            f"{peaks()}")
        for k in ("exit_message", "it_ssl", "it_mg"):
            check(run["info"][k] == ref["info"][k], (label, k))
        check(diff <= 1e-5, (label, diff))
        paths[f"multi_device_{key}"] = run["launches"]
        del run

    # The task axis over 2 and 3 entries of E.
    freqs = [0.25, 0.5, 1.0, 2.0]
    model, _ = problems["triaxial"]
    sfields = [get_source_field(model.grid, (0., 0., 0., 0., 0.), f)
               for f in freqs]
    ref_fields, ref_info = batch_ref
    for n in (2, 3):
        mesh = make_task_mesh(devices=E[:n])
        reset_peaks()
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        efields, info = solve_batch_fields(model, sfields, mesh=mesh,
                                           tol=1e-6, **PRODUCTION)
        for i in cards:
            torch.cuda.synchronize(i)
        dt = time.perf_counter() - t0
        counts = kernel_counts()
        diffs = [rel_err(torch.from_numpy(a.field),
                         torch.from_numpy(b.field))
                 for a, b in zip(efields, ref_fields)]
        same = all(np.array_equal(a.field, b.field)
                   for a, b in zip(efields, ref_fields))
        log(f"[multi-device] solve_batch over {n} entries "
            f"{[str(d) for d in E[:n]]} ({len(freqs)} tasks, "
            f"{-len(freqs) % n} padding lane(s)): {dt!r} s, it_ssl "
            f"{info['it_ssl']} / {ref_info['it_ssl']}, it_mg "
            f"{info['it_mg']} / {ref_info['it_mg']}, "
            f"{info['exit_messages']}; lanes' relative differences to the "
            f"unsharded batch {diffs} (bit for bit {same}); launches "
            f"{({k: c[0] for k, c in counts.items()})}, plain calls on "
            f"cuda {({k: c[1] for k, c in counts.items()})}; peak per card "
            f"{peaks()}")
        check(info["exit_messages"] == ["CONVERGED"] * len(freqs), info)
        check((info["it_ssl"], info["it_mg"])
              == (ref_info["it_ssl"], ref_info["it_mg"]), "its")
        check(max(diffs) <= 1e-12, diffs)
        for name, (launches, plain) in counts.items():
            check(launches > 0 and plain == 0, (n, name, launches, plain))
        paths[f"multi_device_batch_{n}_entries"] = {
            k: c[0] for k, c in counts.items()}
        del efields

    kernel_counts(reset=True)
    t0 = time.perf_counter()
    out = dryrun_multichip(len(E), devices=E)
    counts = kernel_counts()
    log(f"[multi-device] dryrun_multichip({len(E)}): {out}, "
        f"{time.perf_counter() - t0:.1f} s, launches "
        f"{({k: c[0] for k, c in counts.items()})}, plain calls on cuda "
        f"{({k: c[1] for k, c in counts.items()})}")
    check(all(c[1] == 0 for c in counts.values()), counts)
    return paths


def largest(a, b):
    """max |a - b| over max |b|, where b is finite."""
    a, b = np.asarray(a), np.asarray(b)
    keep = np.isfinite(b)
    return float(np.abs(a - b)[keep].max() / np.abs(b[keep]).max())


def salt_survey_results(n, nsrc, parallel, tol, observed=None):
    """The salt survey of ``phase_survey`` at ``n``^3 with ``nsrc``
    sources through ``parallel``, every task solved to ``tol`` (in
    complex128 below 1e-6): synthetic data of the salt model, then misfit,
    gradient and ``jvec`` of the salt box on the model of weaker salt
    against ``observed`` (None: this run's synthetic data with seeded
    noise).  Returns those and the observed data."""
    from emg3d_tpu_torch import Simulation, northstar

    opts = {'tol': tol, **PRODUCTION}
    if tol < 1e-6:
        opts['dtype'] = torch.complex128
    survey, model, kw = northstar.salt_survey(n, nsrc)
    kw.update(tqdm_opts=False, parallel=parallel, solver_opts=opts)
    sim = Simulation(survey, model, **kw)
    sim.compute(observed=observed is None, rng=np.random.default_rng(20))
    check_tasks(sim, 'efield', tol)
    synthetic = np.asarray(sim.data.synthetic).copy()
    if observed is None:
        observed = np.asarray(sim.data.observed).copy()
    survey2 = northstar.salt_survey(n, nsrc)[0]
    survey2.data['observed'] = observed
    sim2 = Simulation(survey2, northstar.salt_model(
        model.grid, salt_scale=0.8), **kw)
    out = {"synthetic": synthetic, "misfit": sim2.misfit,
           "gradient": sim2.gradient.copy(),
           "jvec": np.asarray(sim2.jvec(northstar.salt_box(
               model.grid))).copy()}
    check_tasks(sim2, 'efield', tol)
    check_tasks(sim2, 'bfield', tol)
    return out, observed


# Tolerance of the engines' tight comparison, and the limit there.
TIGHT_TOL, TIGHT_LIMIT = 1e-9, 1e-5


def survey_tolerance_witness(n=64, nsrc=8):
    """The salt survey at ``n``^3 with ``nsrc`` sources, ``nsrc`` lanes
    per batch, through both engines at the 128^3 phases' tol 1e-6 and at
    ``TIGHT_TOL``, on one set of observed data.  At ``TIGHT_TOL`` the two
    engines agree to ``TIGHT_LIMIT`` (data, misfit, gradient, ``jvec``).
    At 1e-6 each engine lies from the tight answer as far as the other
    does from it (the batch within four times the task loop, or within
    ``TIGHT_LIMIT``): what differs between the engines at 1e-6 is what
    that tolerance leaves unfixed.  Returns the largest relative
    differences {pair: {quantity: difference}}."""
    t0 = time.perf_counter()
    runs, obs = {}, None
    for label, parallel, tol in (("task tight", 'task', TIGHT_TOL),
                                 ("batch tight", 'batch', TIGHT_TOL),
                                 ("task 1e-6", 'task', 1e-6),
                                 ("batch 1e-6", 'batch', 1e-6)):
        runs[label], obs = salt_survey_results(n, nsrc, parallel, tol, obs)
    diffs = {f"{a} vs {b}": {k: largest(runs[a][k], runs[b][k])
                             for k in runs[b]}
             for a, b in (("batch tight", "task tight"),
                          ("task 1e-6", "task tight"),
                          ("batch 1e-6", "task tight"),
                          ("batch 1e-6", "task 1e-6"))}
    log(f"[survey batch] salt survey {n}^3 x {nsrc} sources ({nsrc} lanes), "
        f"tight tol {TIGHT_TOL:g} in complex128, 1e-6 in the card's "
        f"default precision, one set of observed data (largest difference "
        f"relative to the largest entry): {diffs} "
        f"({time.perf_counter() - t0:.1f} s)")
    for name, err in diffs["batch tight vs task tight"].items():
        check(err <= TIGHT_LIMIT, ("tight", name, err))
    for name, err in diffs["batch 1e-6 vs task tight"].items():
        check(err <= max(4 * diffs["task 1e-6 vs task tight"][name],
                         TIGHT_LIMIT), ("witness", name, err))
    return diffs


# Limits of the 128^3 batched survey against the task loop: four times
# what an H100 gave.  Both sides stop at a relative residual of 1e-6,
# which bounds the fields' error against their largest values; the
# weakest data (down to 2e-17 against 3.6e-10, weights 1 / (3 % of the
# datum)^2) are far below that, and misfit, gradient and jvec weigh them
# most.  ``survey_tolerance_witness`` shows this at 64^3, where the task
# loop at 1e-6 lies as far from its tight answer, and holds the two
# engines, 4 lanes, to 1e-5 where both solve to 1e-9: the check that
# catches a fault of the engine these loose limits would let pass.
SURVEY_BATCH_LIMITS = {"synthetic": 1e-4, "misfit": 0.064, "gradient": 0.38,
                       "jvec": 0.024}


def phase_survey_batch(ref, n=128, nsrc=8):
    """The salt survey of ``phase_survey`` through
    ``Simulation(parallel='batch')``: first both engines at 64^3 to a
    tight tolerance and to 1e-6 (``survey_tolerance_witness``), then at
    ``n``^3 one batch of ``nsrc`` lanes per solve stage, held against
    ``ref``, the task loop's results of the same run.
    Returns {kernel: launches} of the ``n``^3 run."""
    from emg3d_tpu_torch import Simulation, northstar, tracing

    survey_tolerance_witness(nsrc=4)
    survey, model, kw = northstar.salt_survey(n, nsrc)
    kw.update(tqdm_opts=False, parallel='batch',
              solver_opts={'tol': 1e-6, **PRODUCTION})
    grid = model.grid
    cells = int(np.prod(model.shape))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    stages = {}

    def stage(name, nbatches, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        tracing.clear()
        with tracing.recording():
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        inside = [r.seconds for r in tracing.roots()]
        check(len(inside) == nbatches, (name, len(inside), nbatches))
        peak = torch.cuda.max_memory_allocated()
        stages[name] = (dt, sum(inside), peak)
        log(f"[survey batch] {name}: {dt!r} s, {nbatches} batched solve(s) "
            f"of {nsrc} lanes, {sum(inside)!r} s inside them "
            f"({[round(t, 3) for t in inside]}), "
            f"{100 * (1 - sum(inside) / dt):.1f} % outside; "
            f"max_memory_allocated {peak} B ({peak // nsrc} B per lane; "
            f"allocated at the stage's start {start} B)")
        return out

    sim = Simulation(survey, model, **kw)
    check(sim.device == 'cuda' and sim.parallel == 'batch', sim.device)
    stage("forward", 1, sim.compute)
    its = check_tasks(sim, 'efield', 1e-6)
    errs = {"synthetic": largest(sim.data.synthetic, ref["synthetic"])}

    survey2 = northstar.salt_survey(n, nsrc)[0]
    survey2.data['observed'] = ref["observed"]
    sim2 = Simulation(survey2, northstar.salt_model(grid, salt_scale=0.8),
                      **kw)
    del sim
    misfit, grad = stage("misfit and gradient", 2,
                         lambda: (sim2.misfit, sim2.gradient))
    its += check_tasks(sim2, 'efield', 1e-6) + check_tasks(
        sim2, 'bfield', 1e-6)
    errs["misfit"] = abs(misfit - ref["misfit"]) / ref["misfit"]
    errs["gradient"] = largest(grad, ref["gradient"])
    jvec = stage("jvec", 1, lambda: sim2.jvec(northstar.salt_box(grid)))
    errs["jvec"] = largest(jvec, ref["jvec"])

    counts = kernel_counts()
    total, inside = (sum(s[i] for s in stages.values()) for i in (0, 1))
    nsolves = 4 * nsrc
    log(f"[survey batch] whole path: {total!r} s for {nsolves} solves in 4 "
        f"batches ({cells * nsolves / total:.0f} cells x solves / s), "
        f"{100 * (1 - inside / total):.1f} % outside the batched solves; "
        f"(it_ssl, it_mg) per batch {sorted(set(its))}; "
        f"max_memory_allocated {max(st[2] for st in stages.values())} B; "
        f"launches {({k: c[0] for k, c in counts.items()})}, plain calls on "
        f"cuda {({k: c[1] for k, c in counts.items()})}; against the task "
        f"loop (largest difference relative to the largest entry; misfit "
        f"relative) {errs}")
    for name, (launches, plain) in counts.items():
        check(launches > 0, (name, "not launched on the batched survey"))
        check(plain == 0, (name, "plain calls on CUDA", plain))
    for name, err in errs.items():
        check(err <= SURVEY_BATCH_LIMITS[name], (name, err))
    check(np.all(np.isfinite(grad)) and np.all(np.isfinite(jvec)), "finite")
    return {k: c[0] for k, c in counts.items()}


# Limit of |<w, Re(J v)> - <v, J^T w>| over the mean of the two, four
# times what an H100 gave for the problem of ``phase_adjoint``.
ADJOINT_RTOL = 1.3e-8


def small_survey(n, seed, mapping, nfreq):
    """A stretched triaxial ``n``^3 survey centred on its two sources,
    with two electric receivers and a magnetic one."""
    from emg3d_tpu_torch import (Model, RxElectricPoint, RxMagneticPoint,
                                 Survey, TensorMesh, TxElectricDipole, maps)

    rng = np.random.default_rng(seed)
    h = [rng.uniform(60.0, 140.0, n) for _ in range(3)]
    grid = TensorMesh(h, origin=tuple(-0.5 * x.sum() for x in h))
    shape = grid.shape_cells
    pmap = getattr(maps, 'Map' + mapping)()
    model = Model(grid, mapping=mapping, **{
        f"property_{d}": pmap.forward(1.0 / rng.uniform(lo, hi, shape))
        for d, lo, hi in (('x', 1, 3), ('y', 1, 4), ('z', 2, 6))})
    w = 100.0 * n / 16
    survey = Survey(
        sources=[TxElectricDipole((x, 0., 0., 20., 10.))
                 for x in (-w, w)],
        receivers=[RxElectricPoint((3 * w, w, 0., 0., 0.)),
                   RxElectricPoint((-2 * w, -2 * w, w / 2, 90., 0.)),
                   RxMagneticPoint((2 * w, -w, w, 90., 0.))],
        frequencies=[0.5, 1.0][:nfreq], relative_error=0.05,
        noise_floor=1e-17)
    return survey, model


def phase_adjoint():
    from emg3d_tpu_torch import Simulation

    survey, model = small_survey(32, 32, 'LgResistivity', 2)
    sim = Simulation(
        survey, model, gridding='same', receiver_interpolation='linear',
        tqdm_opts=False, verb=-1,
        solver_opts={'tol': 1e-9, 'tol_gradient': 1e-9})
    t0 = time.perf_counter()
    sim.compute(observed=True, add_noise=False)
    its = check_tasks(sim, 'efield', 1e-9)
    rng = np.random.default_rng(33)
    v = rng.standard_normal((3, *model.shape))
    w = rng.standard_normal(survey.shape)
    lhs = float(np.sum(w * sim.jvec(v).real))
    rhs = float(np.sum(v * sim.jtvec(w)))
    check_tasks(sim, 'bfield', 1e-9)
    err = abs(lhs - rhs) / (0.5 * (abs(lhs) + abs(rhs)))
    log(f"[adjoint] 32^3 stretched triaxial LgResistivity, 2 sources x 2 "
        f"frequencies, tol and tol_gradient 1e-9, working precision "
        f"complex64 (the card's default): forward it_ssl/it_mg {its}; "
        f"<w, Re(J v)> {lhs!r}, <v, J^T w> {rhs!r}, relative difference "
        f"{err!r} (limit {ADJOINT_RTOL:g}); "
        f"{time.perf_counter() - t0:.1f} s")
    check(np.isfinite(lhs) and lhs != 0.0, lhs)
    check(err <= ADJOINT_RTOL, ("adjointness", err))


def phase_survey_card_vs_cpu():
    from emg3d_tpu_torch import Simulation, get_magnetic_field

    sims = {}
    for label, device in (('card', None), ('cpu', 'cpu')):
        survey, model = small_survey(16, 16, 'Resistivity', 1)
        sim = Simulation(
            survey, model, gridding='same', receiver_interpolation='linear',
            tqdm_opts=False, verb=-1, device=device,
            solver_opts={'tol': 1e-6, 'dtype': torch.complex128})
        t0 = time.perf_counter()
        # Observed data: the model's own responses, 10 % larger.
        sim.compute(observed=True, add_noise=False)
        forward = {src: sim.get_efield_info(src, freq)
                   for src, freq in sim._srcfreq}
        sim.data['observed'] = sim.data.observed * 1.1
        _ = sim.gradient
        sims[label] = (sim, time.perf_counter() - t0, forward)
    (gpu, t_gpu, f_gpu), (cpu, t_cpu, f_cpu) = sims['card'], sims['cpu']
    check((gpu.device, cpu.device) == ('cuda', 'cpu'), (gpu.device,
                                                        cpu.device))

    def diff(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max() / np.abs(b).max())

    errs = {"observed": diff(gpu.data.observed, cpu.data.observed),
            "synthetic": diff(gpu.data.synthetic, cpu.data.synthetic),
            "misfit": diff(gpu.misfit, cpu.misfit),
            "gradient": diff(gpu.gradient, cpu.gradient)}
    its = {}
    for src, freq in gpu._srcfreq:
        for which, a, b in (
                ('efield', f_gpu[src], f_cpu[src]),
                ('bfield', *(s._dict_get('bfield_info', src, freq)
                             for s in (gpu, cpu)))):
            its[f"{which} {src}"] = (a['it_ssl'], a['it_mg'])
            check(a['exit'] == b['exit'] == 0 and a['it_ssl'] > 0,
                  (which, src))
            check((a['it_ssl'], a['it_mg']) == (b['it_ssl'], b['it_mg']),
                  (which, src, a['it_ssl'], b['it_ssl'], a['it_mg'],
                   b['it_mg']))
    efield = cpu.get_efield('TxED-1', 'f-1')
    h_gpu = get_magnetic_field(cpu.model, efield)
    h_cpu = get_magnetic_field(cpu.model, efield, device='cpu')
    errs["get_magnetic_field"] = diff(h_gpu.field, h_cpu.field)
    log(f"[survey parity] 16^3 stretched triaxial survey, 2 sources, "
        f"electric and magnetic receivers, complex128: card {t_gpu:.2f} s, "
        f"cpu {t_cpu:.2f} s; (it_ssl, it_mg) per task on both {its}; largest "
        f"differences relative to the largest entry {errs}")
    check(np.abs(h_cpu.field).max() > 0 and gpu.misfit > 0, "zero")
    for name, err in errs.items():
        check(err <= (1e-12 if name == "get_magnetic_field" else 1e-8),
              (name, err))

    # Round trip through files in a temporary directory (.npz and .json
    # need no h5py; .h5 and file_dir are held by the CPU tests).
    with tempfile.TemporaryDirectory() as tmp:
        for ext in ('npz', 'json'):
            fname = str(pathlib.Path(tmp) / f"simulation.{ext}")
            gpu.to_file(fname, what='computed')
            back = Simulation.from_file(fname)
            check(back.device == 'cuda' and back.solver_opts['dtype']
                  == 'complex128', (ext, back.device, back.solver_opts))
            for name in ('observed', 'synthetic'):
                check(np.array_equal(np.asarray(back.data[name]),
                                     np.asarray(gpu.data[name])), (ext, name))
            check(np.array_equal(back.gradient, gpu.gradient), ext)
            for which in ('efield', 'bfield'):
                for src, freq in gpu._srcfreq:
                    check(np.array_equal(
                        back._dict_get(which, src, freq).field,
                        gpu._dict_get(which, src, freq).field),
                        (ext, which, src))
            log(f"[round trip] Simulation.to_file/from_file .{ext}: data, "
                f"gradient and fields equal")
    log(f"[round trip] h5py can be imported here: "
        f"{importlib.util.find_spec('h5py') is not None}")


def lg_model(model):
    """``model`` (isotropic, resistivity) in the mapping of the inversion
    tests, log10 of the resistivity."""
    from emg3d_tpu_torch import Model

    return Model(model.grid, property_x=np.log10(model.property_x),
                 mapping='LgResistivity')


def phase_inversion(n=64, nsrc=4, maxiter=3):
    """``inversion.native.minimize`` (L-BFGS-B, ``maxiter`` iterations) of
    the salt survey at ``n``^3 with ``nsrc`` sources through
    ``Simulation`` with no device: observed data of the true model, start
    model with the salt 0.8 times as resistive, in ``LgResistivity``.
    Every solve converges; the misfit falls; after the first evaluation
    nothing is captured; the first evaluation equals a per-operation
    evaluation (``EMG3D_TPU_CYCLE_JIT=0``) of the same model to 1e-10."""
    from emg3d_tpu_torch import Simulation, northstar, solver
    from emg3d_tpu_torch.inversion import native

    t_start = time.perf_counter()
    survey, model, kw = northstar.salt_survey(n, nsrc)
    kw['tqdm_opts'] = False
    true = Simulation(survey, lg_model(model), **kw)
    check(true.device == 'cuda', true.device)
    true.compute(observed=True, add_noise=False)
    observed = np.asarray(true.data.observed).copy()
    start = lg_model(northstar.salt_model(model.grid, salt_scale=0.8))

    def simulation():
        obs_survey = northstar.salt_survey(n, nsrc)[0]
        obs_survey.data['observed'] = observed
        return Simulation(obs_survey, start, **kw)

    def its(sim):
        return [i for which in ('efield', 'bfield')
                for i in check_tasks(sim, which, 1e-6)]

    # The per-operation evaluation of the start model.
    os.environ["EMG3D_TPU_CYCLE_JIT"] = "0"
    try:
        ref_sim = simulation()
        fun, _, m0 = native._make_objective(ref_sim)
        t0 = time.perf_counter()
        phi_ref, grad_ref = fun(m0)
        dt_ref = time.perf_counter() - t0
        its_ref = its(ref_sim)
    finally:
        del os.environ["EMG3D_TPU_CYCLE_JIT"]
    log(f"[inversion] salt {model.shape} x {nsrc} sources, per-operation "
        f"evaluation of the start model: misfit {phi_ref!r}, (it_ssl, it_mg)"
        f" per task {its_ref}, {dt_ref:.2f} s")

    evals = []
    make_objective = native._make_objective

    def traced(sim):
        fun, set_model, m0 = make_objective(sim)

        def evaluate(m):
            solver.reset_counts()
            t0 = time.perf_counter()
            phi, grad = fun(m)
            dt = time.perf_counter() - t0
            evals.append((phi, grad.copy(), solver.CYCLE_CAPTURES,
                          solver.CYCLE_REPLAYS))
            log(f"[inversion] evaluation {len(evals)}: misfit {phi!r}, "
                f"(it_ssl, it_mg) per task {its(sim)}, {dt:.2f} s, cycle "
                f"graphs: {solver.CYCLE_CAPTURES} captures, "
                f"{solver.CYCLE_REPLAYS} replays")
            return phi, grad

        return evaluate, set_model, m0

    sim = simulation()
    solver._STEPS.clear()       # the inversion captures its own steps
    with unittest.mock.patch.object(native, '_make_objective', traced):
        result = native.minimize(sim, maxiter=maxiter, verb=0)
    phi1, grad1 = evals[0][:2]
    err_phi = abs(phi1 - phi_ref) / phi_ref
    err_grad = float(np.linalg.norm(grad1 - grad_ref)
                     / np.linalg.norm(grad_ref))
    captures = sum(e[2] for e in evals)
    replays = sum(e[3] for e in evals)
    log(f"[inversion] {result!r}: {result.message}; misfit {result.misfit0!r}"
        f" -> {result.misfit!r}; {captures} captures, {replays} replays in "
        f"{len(evals)} evaluations; first evaluation against the "
        f"per-operation one: misfit {err_phi!r}, gradient {err_grad!r} "
        f"(relative); {time.perf_counter() - t_start:.1f} s")
    check(result.model is sim.model, "result model")
    check(np.isfinite(result.misfit) and result.misfit < result.misfit0,
          (result.misfit0, result.misfit))
    check(evals[0][2] > 0, "evaluation 1 captured nothing")
    check(all(e[2] == 0 for e in evals[1:]), "captured after evaluation 1")
    check(replays >= 10 * captures, (captures, replays))
    check(err_phi <= 1e-10 and err_grad <= 1e-10, (err_phi, err_grad))


# The salt survey's CLI config (``northstar.salt_survey``'s keywords, no
# device: the card).
CLI_CONFIG = """[simulation]
gridding = same
receiver_interpolation = linear

[solver_opts]
tol = 1e-6
"""


def run_cli(args, timeout=900):
    """``python3 -m emg3d_tpu_torch *args`` from the root of the
    checkout; the finished process."""
    proc = subprocess.run([sys.executable, "-m", "emg3d_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    check(proc.returncode == 0, (args, proc.stdout[-2000:],
                                 proc.stderr[-4000:]))
    return proc


def cli_iterations(logfile, field):
    """The (it_ssl, it_mg) of every solve of ``field`` that the CLI's log
    file lists."""
    its = []
    with open(logfile) as f:
        for line in f:
            words = line.replace(",", "").split()
            if words[:1] == [field] and "it_ssl" in words:
                its.append((int(words[words.index("it_ssl") + 1]),
                            int(words[words.index("it_mg") + 1])))
    return its


def phase_cli(ref, n=128, nsrc=8):
    """The command line at full width: the salt survey of
    ``phase_survey`` (with the observed data made there) and the model
    of weaker salt, written with ``io.save`` as ``.npz``, through
    ``python3 -m emg3d_tpu_torch -g`` with a config that names no device
    (so the card), in a process of its own.  Data, misfit and gradient of
    ``out.npz`` must equal the task loop's of ``phase_survey`` (``ref``)
    to 1e-12 relative to the largest entry.  The launch counts are read
    in that process just after the run (which starts them at 0).  Then
    ``--report`` and a dry run (``-d``), both through ``python3 -m``.
    Returns {kernel: launches} of the ``-g`` run."""
    from emg3d_tpu_torch import io, northstar

    survey, model, _ = northstar.salt_survey(n, nsrc)
    survey.data['observed'] = ref["observed"]
    with tempfile.TemporaryDirectory() as tmp:
        io.save(os.path.join(tmp, "survey.npz"), survey=survey, verb=0)
        io.save(os.path.join(tmp, "model.npz"), model=northstar.salt_model(
            model.grid, salt_scale=0.8), verb=0)
        config = os.path.join(tmp, "emg3d.cfg")
        with open(config, "w") as f:
            f.write(CLI_CONFIG)
        files = ["--path", tmp, "--survey", "survey.npz", "--model",
                 "model.npz"]

        # The -g run, as ``python3 -m emg3d_tpu_torch`` runs it, with the
        # counts of that process printed after it.
        args = [config, "-g", *files, "--output", "out.npz"]
        code = (
            "import json, runpy, sys\n"
            "from emg3d_tpu_torch import solver\n"
            "from emg3d_tpu_torch.ops import gs_phase, line_phase\n"
            f"sys.argv = ['emg3d_tpu_torch', *{args!r}]\n"
            "try:\n"
            "    runpy.run_module('emg3d_tpu_torch', run_name='__main__',\n"
            "                     alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    if e.code:\n"
            "        raise\n"
            "print(json.dumps({'launches': {m.__name__.split('.')[-1]: "
            "[m.LAUNCHES, m.PLAIN_CALLS_ON_CUDA] for m in (gs_phase, "
            "line_phase)}, 'captures': solver.CYCLE_CAPTURES, 'replays': "
            "solver.CYCLE_REPLAYS}))\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, (proc.stdout[-2000:],
                                     proc.stderr[-4000:]))
        counts = json.loads(proc.stdout.strip().splitlines()[-1])
        out = io.load(os.path.join(tmp, "out.npz"))
        logfile = os.path.join(tmp, "out.log")
        its = {f: cli_iterations(logfile, f) for f in ("efield", "bfield")}
        errs = {"data": largest(out["data"], ref["synthetic_weak"]),
                "misfit": abs(out["misfit"] - ref["misfit"]) / ref["misfit"],
                "gradient": largest(out["gradient"], ref["gradient"])}
        log(f"[cli] python3 -m emg3d_tpu_torch -g on the salt survey "
            f"{model.shape} x {nsrc} sources (no device in the config): "
            f"{wall!r} s with the start of the process; (it_ssl, it_mg) of "
            f"the forward solves {its['efield']}, of the adjoint solves "
            f"{its['bfield']} (from its log file); launches through the "
            f"wrappers in that process {counts['launches']} (first uses "
            f"and captures), cycle graphs: {counts['captures']} captures, "
            f"{counts['replays']} replays; misfit {out['misfit']!r}, "
            f"n_observations {out['n_observations']}; against the task "
            f"loop of [survey] (largest difference relative to the largest "
            f"entry; misfit relative) {errs}, bit for bit "
            f"{bool(np.array_equal(out['gradient'], ref['gradient']))}")
        check(out["data"].shape == survey.shape, out["data"].shape)
        check(out["gradient"].shape == model.shape, out["gradient"].shape)
        check(len(its["efield"]) == len(its["bfield"]) == nsrc, its)
        for name, err in errs.items():
            check(err <= 1e-12, (name, err))
        for name, (launches, plain) in counts["launches"].items():
            check(launches > 0, (name, "not launched by the CLI"))
            check(plain == 0, (name, "plain calls on CUDA", plain))

        # --report and a dry run, the two processes started together.
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            report, _ = pool.map(lambda args: run_cli(args, timeout=300), (
                ["--report"], [config, "-d", *files, "--output", "dry.npz"]))
        dt = time.perf_counter() - t0
        report = report.stdout
        dry = io.load(os.path.join(tmp, "dry.npz"))
        log(f"[cli] --report and -d, started together, both ended after "
            f"{dt:.1f} s; --report:\n{report.strip()}")
        log(f"[cli] -d (dry run): data {dry['data'].shape}, all zero "
            f"{bool(np.all(dry['data'] == 0))}")
        check("torch" in report and "Devices: " in report, report)
        check(dry["data"].shape == survey.shape and np.all(dry["data"] == 0),
              "dry run")
    return {k: c[0] for k, c in counts["launches"].items()}


# tools/bench_time.py's recipe with the JAX package (x64, on the CPU) at
# 64^3, the numbers ``phase_time_domain`` holds the card's against: the
# transient at 900 m at the 13 times of ``np.logspace(-2, 1, 13)``, and
# it_mg per frequency as (it_mg, frequencies in a row), from the lowest
# frequency up.  tests/test_torch_time_domain.py::
# test_time_domain_64_reference (marked slow; with ``-s`` it prints
# them) computes them and holds them to these.  Its largest error against
# the closed form over the filter's core (times 1-9) is 0.2060, at
# 1.78 s: the recipe's own ``ok`` (below 0.15) does not hold at 64^3 with
# either package.
TIME_DOMAIN_REFERENCE = {
    "transient": [
        2.318025516180219e-10, 2.317362170684421e-10,
        2.30456000396455e-10, 2.20573193186127e-10,
        1.8673092501582603e-10, 1.3078414742311856e-10,
        7.689211170781607e-11, 4.020852260756182e-11,
        1.9889839837879046e-11, 9.84605660801657e-12,
        4.786686231087338e-12, 1.7772594928681354e-12,
        3.299553260924226e-13],
    "it_mg": [(6, 110), (5, 9), (4, 6), (3, 3)],
}
# Limit of |card - reference| / |closed form| per time: four times what
# an H100 gave in its default working precision (complex64 smoothing;
# 1.0e-3 at 0.01 s, where the transient rests on the weakest responses).
TIME_DOMAIN_LIMIT = 4e-3


def run_lengths(values):
    """[(value, times in a row), ...] of a sequence."""
    return [(v, len(list(g))) for v, g in itertools.groupby(values)]


def phase_time_domain(n=64):
    """North-star configuration 5 on the card: ``northstar.time_domain(n)``
    (a 1 Ohm m fullspace of ``n``^3 cells of 100 m, one plain F-cycle
    solve per frequency ``Fourier`` needs between 1e-3 and 100 Hz, the
    transient at 900 m), both launch counts set to 0 just before and
    read just after, from an empty step cache.  Every solve converges
    below 1e-6, in as many cycles as the JAX recipe's, give or take one;
    the transient lies within ``TIME_DOMAIN_LIMIT`` of the JAX recipe's
    (``TIME_DOMAIN_REFERENCE``) relative to the closed form
    (tests/alternatives.fullspace_dipole_time) at every time.  The error
    against the closed form over the filter's core is printed beside
    tools/bench_time.py's limit 0.15 (which the reference misses too).
    Then the recipe at 16^3 on 4 frequencies, card against CPU in
    complex128: the same ``it_mg`` per frequency, responses and transient
    to 1e-10.  Returns {kernel: launches} of the ``n``^3 run."""
    from emg3d_tpu_torch import northstar, solver

    sys.path.insert(0, str(ROOT / "tests"))
    import alternatives

    times, offset = np.logspace(-2, 1, 13), 900.0
    solver._STEPS.clear()       # the sweep captures its own step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    solver.reset_counts()
    t0 = time.perf_counter()
    transient, per_freq = northstar.time_domain(n, times=times,
                                                offset=offset)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    captures, replays = solver.CYCLE_CAPTURES, solver.CYCLE_REPLAYS
    exact = alternatives.fullspace_dipole_time(
        np.array([[offset, 0., 0.]]), (0., 0., 0.), times, 1.0,
        signal=-1)[:, 0, 0]
    err = np.abs(transient - exact) / np.abs(exact)
    core = float(err[1:10].max())
    ref = np.array(TIME_DOMAIN_REFERENCE["transient"])
    ref_err = np.abs(ref - exact) / np.abs(exact)
    to_ref = np.abs(transient - ref) / np.abs(exact)
    ref_its = [v for v, k in TIME_DOMAIN_REFERENCE["it_mg"] for _ in range(k)]
    its = [p["it_mg"] for p in per_freq]
    secs = [p["seconds"] for p in per_freq]
    freqs = [p["frequency"] for p in per_freq]
    messages = sorted({p["exit_message"] for p in per_freq})
    log(f"[time domain] {n}^3 fullspace, {len(per_freq)} frequencies "
        f"{min(freqs):.6g}-{max(freqs):.6g} Hz, plain F-cycles to 1e-6: "
        f"{wall!r} s in all, first solve {secs[0]!r} s, warm "
        f"{sum(secs[1:]) / max(len(secs) - 1, 1)!r} s per frequency; it_mg "
        f"{min(its)}-{max(its)} (in a row {run_lengths(its)}; the JAX "
        f"recipe's {TIME_DOMAIN_REFERENCE['it_mg']}); exit messages "
        f"{messages}; rel_error up to "
        f"{max(p['rel_error'] for p in per_freq)!r}; cycle graphs: "
        f"{captures} captures, {replays} replays; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches through the "
        f"wrappers {({k: c[0] for k, c in counts.items()})}, plain calls on "
        f"cuda {({k: c[1] for k, c in counts.items()})}")
    log(f"[time domain] transient at {offset} m against the closed form: "
        f"relative error per time {[float(f'{e:.4g}') for e in err]} (the "
        f"JAX recipe's {[float(f'{e:.4g}') for e in ref_err]}); largest "
        f"over the core (times 1-9) {core!r} (the JAX recipe's "
        f"{float(ref_err[1:10].max())!r}; tools/bench_time.py's limit 0.15"
        f", met: {core < 0.15}), median {float(np.median(err))!r}; "
        f"|card - JAX recipe| / |closed form| per time "
        f"{[float(f'{e:.3g}') for e in to_ref]} (limit {TIME_DOMAIN_LIMIT})")
    check(len(per_freq) == 128, len(per_freq))
    check(messages == ["CONVERGED"], messages)
    check(all(p["rel_error"] < 1e-6 for p in per_freq), "rel_error")
    check(max(abs(a - b) for a, b in zip(its, ref_its)) <= 1, "it_mg")
    check(np.all(np.isfinite(transient)), "transient")
    check(float(to_ref.max()) <= TIME_DOMAIN_LIMIT, ("transient", to_ref))
    check(counts["gs_phase"][0] > 0 and counts["line_phase"][0] == 0, counts)
    check(all(c[1] == 0 for c in counts.values()), counts)
    check(captures > 0 and replays > captures, (captures, replays))

    band = dict(fmin=0.85, fmax=1.2, offset=400.0, times=times,
                dtype=torch.complex128)
    t0 = time.perf_counter()
    t_gpu, f_gpu = northstar.time_domain(16, **band)
    t1 = time.perf_counter()
    t_cpu, f_cpu = northstar.time_domain(16, device="cpu", **band)
    t2 = time.perf_counter()
    r_gpu, r_cpu = (np.array([p["response"] for p in f]) for f in
                    (f_gpu, f_cpu))
    errs = {"responses": largest(r_gpu, r_cpu),
            "transient": largest(t_gpu, t_cpu)}
    log(f"[time domain parity] 16^3, {len(f_gpu)} frequencies, complex128: "
        f"card {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s; it_mg "
        f"{[p['it_mg'] for p in f_gpu]} / {[p['it_mg'] for p in f_cpu]}; "
        f"largest differences relative to the largest entry {errs}")
    check(len(f_gpu) == 4, len(f_gpu))
    check([p["it_mg"] for p in f_gpu] == [p["it_mg"] for p in f_cpu],
          "it_mg")
    for name, e in errs.items():
        check(e <= 1e-10, (name, e))
    return {k: c[0] for k, c in counts.items()}


def phase_laplace(problem):
    """A Laplace-domain solve at full width: ``problem``, the main paths'
    ``northstar.laplace_problem`` (the triaxial 128^3 model, source at
    frequency -1, real fields), with the solver's default options and
    no device, through ``drive_modes``:
    in float32 on the card, so every kernel run of the profiled graph
    solve is a float32 instantiation, and its first graph solve captures
    steps of its own (the triaxial solve of the same grid made complex
    ones).  Then the 32^3 problem in float64, card against CPU: the same
    iterations and fields to 1e-10.  Returns {kernel: launches} of the
    per-operation solve."""
    from emg3d_tpu_torch import northstar, solve

    runs = drive_modes("Laplace triaxial default solver", problem,
                       ["gs_phase", "line_phase"], tol=1e-6,
                       **northstar.SOLVE_OPTIONS["laplace"])
    kinds = runs["graph, profiled"]["instantiations"]
    log(f"[laplace] {problem[0].shape}: host field {runs['graph']['field'].dtype}; "
        f"kernel instantiations the profiled graph solve ran {kinds}; the "
        f"first graph solve captured {runs['graph']['captures']} steps")
    check(runs["graph"]["field"].dtype == np.float64, "real field")
    check(kinds and all("_kernel<float, float," in k for k in kinds), kinds)
    check(runs["graph"]["captures"] > 0, "no steps of its own")

    model, sfield = northstar.laplace_problem(32)
    kw = dict(tol=1e-6, return_info=True, dtype=torch.float64)
    t0 = time.perf_counter()
    ef_gpu, inf_gpu = solve(model, sfield, **kw)
    t1 = time.perf_counter()
    ef_cpu, inf_cpu = solve(model, sfield, device='cpu', **kw)
    t2 = time.perf_counter()
    err = rel_err(torch.from_numpy(np.asarray(ef_gpu.field)),
                  torch.from_numpy(np.asarray(ef_cpu.field)))
    log(f"[laplace parity] 32^3 float64, default solver: card it_ssl "
        f"{inf_gpu['it_ssl']} it_mg {inf_gpu['it_mg']} ({t1 - t0:.2f} s), "
        f"cpu it_ssl {inf_cpu['it_ssl']} it_mg {inf_cpu['it_mg']} "
        f"({t2 - t1:.2f} s), field rel diff {err:.2e}")
    for key in ("exit_message", "it_ssl", "it_mg"):
        check(inf_gpu[key] == inf_cpu[key], (key, inf_gpu[key],
                                             inf_cpu[key]))
    check(inf_gpu["exit"] == 0 and ef_gpu.field.dtype == np.float64, "fp64")
    check(err <= 1e-10, ("laplace parity", err))
    return runs["per-operation"]["launches"]


# The examples, each with the start of the line of its result.
EXAMPLES = {"torch_01_marine_csem_forward.py": "solver: CONVERGED in",
            "torch_02_gradient_and_sensitivities.py": "jvec: ",
            "torch_03_transient_fullspace.py": "  10.000 "}


def phase_examples():
    """The examples on the card, each in a process of its own, the three
    started together: exit 0 and the line of its result."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, f"examples/{name}"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            lines = out.splitlines()
            log(f"[examples] {name}: ended {time.perf_counter() - t0:.1f} s "
                f"after the three processes started; " + " | ".join(
                    line.strip() for line in lines[-4:]))
            check(proc.returncode == 0, (name, err[-4000:]))
            check(any(line.startswith(EXAMPLES[name]) for line in lines),
                  (name, EXAMPLES[name]))
    finally:
        for proc in procs.values():
            proc.kill()


# ---------------------------------------------------------------------------
# The Krylov variants on the card.
# ---------------------------------------------------------------------------

KRYLOV_VARIANTS = ("cgs", "gcrotmk")
KRYLOV_PARITY = dict(tol=1e-6, return_info=True, dtype=torch.complex128)


def cpu_krylov(ssl):
    """The 16^3 stretched triaxial default solve with ``sslsolver=ssl``
    on the CPU in complex128 (in a worker process): (field, info,
    seconds)."""
    from emg3d_tpu_torch import solve

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    efield, info = solve(*stretched_triaxial(16, 16), device='cpu',
                         sslsolver=ssl, **KRYLOV_PARITY)
    return (np.asarray(efield.field),
            {k: info[k] for k in ("exit", "exit_message", "it_ssl",
                                  "it_mg")},
            time.perf_counter() - t0)


def phase_krylov_variants(problem, bicgstab):
    """CGS and GCROT(m,k) as the default solver's Krylov method on the
    128^3 triaxial problem, each solved twice with whole-cycle graphs (the
    first from an empty step cache, so it captures: the steps are the
    preconditioner's cycles, which BiCGSTAB's solves share), beside
    ``bicgstab``, the warm graph run of the main path's BiCGSTAB.  Every
    run converges below 1e-6 through both kernels.  Then the 16^3
    stretched triaxial grid in complex128, card against CPU (the CPU
    solves in worker processes, started first): the same exit message,
    ``it_ssl`` and ``it_mg``, fields to 1e-10.  Returns {path: {kernel:
    launches through the wrappers}} of each first solve."""
    import multiprocessing

    from emg3d_tpu_torch import solve

    with concurrent.futures.ProcessPoolExecutor(
            len(KRYLOV_VARIANTS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = {ssl: pool.submit(cpu_krylov, ssl) for ssl in KRYLOV_VARIANTS}
        paths = krylov_variants_128(problem, bicgstab)
        model, sfield = stretched_triaxial(16, 16)
        for ssl in KRYLOV_VARIANTS:
            t0 = time.perf_counter()
            ef_gpu, inf_gpu = solve(model, sfield, device='cuda',
                                    sslsolver=ssl, **KRYLOV_PARITY)
            t1 = time.perf_counter()
            field_cpu, inf_cpu, t_cpu = cpu[ssl].result()
            err = rel_err(torch.from_numpy(np.asarray(ef_gpu.field)),
                          torch.from_numpy(field_cpu))
            log(f"[krylov parity] 16^3 stretched triaxial complex128, "
                f"sslsolver={ssl!r}: card it_ssl {inf_gpu['it_ssl']} it_mg "
                f"{inf_gpu['it_mg']} ({t1 - t0:.2f} s), cpu it_ssl "
                f"{inf_cpu['it_ssl']} it_mg {inf_cpu['it_mg']} ({t_cpu:.2f} "
                f"s, a worker process), field rel diff {err:.2e}")
            check(inf_gpu['exit'] == 0 and inf_cpu['exit'] == 0, ssl)
            for key in ("exit_message", "it_ssl", "it_mg"):
                check(inf_gpu[key] == inf_cpu[key],
                      (ssl, key, inf_gpu[key], inf_cpu[key]))
            check(err <= 1e-10, (ssl, err))
    return paths


def krylov_variants_128(problem, bicgstab):
    """The 128^3 part of ``phase_krylov_variants``."""
    from emg3d_tpu_torch import solver

    paths, rows = {}, {"bicgstab": ("graph again", bicgstab)}
    for ssl in KRYLOV_VARIANTS:
        solver._STEPS.clear()
        first = drive(f"triaxial default solver, sslsolver={ssl!r} [graph]",
                      problem, ["gs_phase", "line_phase"], tol=1e-6,
                      sslsolver=ssl)
        warm = drive(f"triaxial default solver, sslsolver={ssl!r} [graph "
                     f"again]", problem, ["gs_phase", "line_phase"],
                     tol=1e-6, sslsolver=ssl)
        check(first["captures"] > 0 and warm["captures"] == 0, ssl)
        paths[f"krylov_{ssl}_triaxial_128"] = first["launches"]
        rows[ssl] = ("graph", first)
        rows[f"{ssl} again"] = ("graph again", warm)
    log("[krylov variants] triaxial 128^3, default solver to tol 1e-6: "
        + "; ".join(
            f"{name} ({kind}): exit {r['info']['exit']} "
            f"{r['info']['exit_message']}, it_ssl {r['info']['it_ssl']}, "
            f"it_mg {r['info']['it_mg']}, rel_error "
            f"{r['info']['rel_error']!r}, {r['seconds']!r} s, peak "
            f"{r['peak']} B" for name, (kind, r) in rows.items()))
    return paths


# ---------------------------------------------------------------------------
# salt_128_frequency_gridding: a multi-frequency survey whose tasks solve
# on automatically built grids (gridding='frequency').
# ---------------------------------------------------------------------------

# Six frequencies from 0.05 to 12 Hz (tools/bench_shape_classes.py:51).
GRIDDING_FREQUENCIES = tuple(
    float(f) for f in np.logspace(np.log10(0.05), np.log10(12.0), 6))
# The options of the automatic gridding (``meshes.construct_mesh``): the
# survey domain holds the sources, the receivers and the salt's upper
# half, down to 4 km; cells there between the model's 62.5 m and 125 m,
# stretched at most 1.3 times per cell in the buffer; centred on the
# sources' line.  On the 128^3 salt model the largest grid has 1,966,080
# cells and the smallest 491,520 (64^3 has 262,144).
GRIDDING_OPTS = {"domain": ([-4000.0, 4000.0], [-2500.0, 2500.0],
                            [-4000.0, 0.0]),
                 "min_width_limits": (62.5, 125.0),
                 "stretching": (1.0, 1.3), "center": (0.0, 0.0, -30.0)}
# The batch stage's shape classes: True is the growth bound 1.35.
GRIDDING_CLASSES = True
# The peak of a stage may exceed the peak of the visits before it by this
# factor at most.
MEMORY_GROWTH = 1.1


def gridding_survey(n=128):
    """salt_128_frequency_gridding at ``n``^3: the salt model on its own
    ``n``^3 grid of the 8 km cube (``northstar.salt_model``); 2
    x-directed sources on y = 0 at z = -30 m, x = -1500 and 1500 m; every
    second of the 12 receivers of the salt survey's line y = +500 m (6:
    the adjoint source fields, one per receiver and task, built on the
    host, are most of the gradient stage); the frequencies of
    ``GRIDDING_FREQUENCIES``; 3 % relative error, noise floor 1e-16.
    Returns (survey, model)."""
    from emg3d_tpu_torch import (RxElectricPoint, Survey, TxElectricPoint,
                                 northstar)

    model = northstar.salt_survey(n, 1)[1]
    survey = Survey(
        sources=[TxElectricPoint((x, 0.0, -30.0, 0.0, 0.0))
                 for x in (-1500.0, 1500.0)],
        receivers=[RxElectricPoint((x, 500.0, -100.0, 0.0, 0.0))
                   for x in np.linspace(-3500.0, 3500.0, 12)[::2]],
        frequencies=list(GRIDDING_FREQUENCIES), noise_floor=1e-16,
        relative_error=0.03)
    return survey, model


def gridding_kw(shape_classes, parallel="task"):
    """The ``Simulation`` keywords of salt_128_frequency_gridding: the
    default solver to tol 1e-6, given in full (``PRODUCTION``: the batch
    engine's defaults are plain multigrid), linear receiver interpolation
    (an exact gradient)."""
    return dict(gridding="frequency", gridding_opts=dict(GRIDDING_OPTS),
                shape_classes=shape_classes, parallel=parallel,
                receiver_interpolation="linear", verb=-1, tqdm_opts=False,
                solver_opts={"tol": 1e-6, **PRODUCTION})


def gridding_problems(n=128):
    """The grids of salt_128_frequency_gridding without and with shape
    classes (every chosen option and every grid's shape printed), and
    {label: (model, source field)} on one grid of each shape: the
    problems whose hierarchies give the level shapes of the path."""
    from emg3d_tpu_torch import Simulation

    survey, model = gridding_survey(n)
    src = next(iter(survey.sources))
    problems = {}
    for classes in (False, GRIDDING_CLASSES):
        sim = Simulation(survey, model, **gridding_kw(classes))
        rows = []
        for f, freq in survey.frequencies.items():
            grid = sim.get_grid(src, f)
            rows.append(f"{freq:.4g} Hz {grid.shape_cells} "
                        f"{grid.n_cells} cells, widths "
                        f"{min(min(h) for h in grid.h):.1f}-"
                        f"{max(max(h) for h in grid.h):.1f} m")
            shape = grid.shape_cells
            if not any(m.shape == shape for m, _ in problems.values()):
                problems[f"{shape} ({freq:.4g} Hz)"] = (
                    sim.get_model(src, f),
                    survey.sources[src].get_field(grid, freq))
        log(f"[gridding] shape_classes={classes!r}: options "
            f"{sim.gridding_opts}; grids: " + "; ".join(rows))
    return problems


def step_cache_bytes():
    """Bytes of the device tensors that the whole-cycle step cache's
    states and level stores hold."""
    from emg3d_tpu_torch import solver

    parts = [(st.e_hi, st.e_lo, st.r, st.s, st.l2)
             for st in solver._STATES.values()]
    parts += [(lvl.ops, lvl.rw, lvl.pm, lvl.ops64)
              for store in solver._STORES.values() for lvl in store.levels]
    return sum({t.data_ptr(): t.nbytes
                for t in solver._leaves(parts)}.values())


def task_rows(rows):
    """A context in which every task of a task loop
    (``parallel.tasks.solve``) appends (kind, grid shape, grid identity,
    running ``max_memory_allocated``, ``memory_allocated``, the bytes the
    step cache holds, info) to ``rows``."""
    import contextlib

    from emg3d_tpu_torch.parallel import tasks

    @contextlib.contextmanager
    def ctx():
        inner = tasks.solve

        def solve(inp):
            out = inner(inp)
            torch.cuda.synchronize()
            kind, grid = (("bfield", inp["sfield"].grid) if "sfield" in inp
                          else ("efield", inp["grid"]))
            rows.append((kind, grid.shape_cells, id(grid),
                         torch.cuda.max_memory_allocated(),
                         torch.cuda.memory_allocated(), step_cache_bytes(),
                         out[1]))
            return out

        tasks.solve = solve
        try:
            yield rows
        finally:
            tasks.solve = inner
    return ctx()


def gridding_stage(name, nsolves, fn, stages, rows=None):
    """Run ``fn`` as one stage of the survey: peak memory from a reset
    at its start, wall time, time inside the solves (``nsolves`` of
    them), per task the running peak where ``rows`` (a list) is given."""
    import contextlib

    from emg3d_tpu_torch import tracing

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = 0 if rows is None else len(rows)
    ctx = contextlib.nullcontext() if rows is None else task_rows(rows)
    tracing.clear()
    with tracing.recording(), ctx:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    inside = [r.seconds for r in tracing.roots()]
    check(len(inside) == nsolves, (name, len(inside), nsolves))
    peak = torch.cuda.max_memory_allocated()
    stages[name] = {"seconds": dt, "inside": sum(inside), "peak": peak,
                    "reserved": torch.cuda.max_memory_reserved(),
                    "rows": [] if rows is None else rows[first:]}
    log(f"[gridding] {name}: {dt!r} s for {nsolves} solves; {sum(inside)!r}"
        f" s inside them ({[round(s, 3) for s in inside]}), "
        f"{100 * (1 - sum(inside) / dt):.1f} % outside; "
        f"max_memory_allocated {peak} B (reserved "
        f"{stages[name]['reserved']} B)")
    return out


def task_iterations(sim, which):
    """Every task converged below 1e-6; returns {grid shape: [(source,
    frequency, it_ssl, it_mg)]}."""
    its = {}
    check_tasks(sim, which, 1e-6)
    for src, freq in sim._srcfreq:
        info = sim._dict_get(f"{which}_info", src, freq)
        shape = sim.get_grid(src, freq).shape_cells
        its.setdefault(shape, []).append((src, freq, info['it_ssl'],
                                          info['it_mg']))
    return its


def gridding_results(sim):
    """Finite data of the survey's shape, a positive misfit and a finite
    gradient on the model's grid that is not zero."""
    data = np.asarray(sim.data.synthetic)
    check(data.shape == sim.survey.shape and np.all(np.isfinite(data)),
          "synthetic")
    check(np.isfinite(sim.misfit) and sim.misfit > 0, sim.misfit)
    grad = sim.gradient
    check(grad.shape == sim.model.shape, grad.shape)
    check(np.all(np.isfinite(grad)) and np.abs(grad).max() > 0, "gradient")
    return {"synthetic": data.copy(), "misfit": sim.misfit,
            "gradient": grad.copy()}


def gridding_engine(label, survey, model, shape_classes, parallel,
                    kernels):
    """One engine on salt_128_frequency_gridding: ``compute`` (synthetic
    data with seeded noise become the observed data), then ``misfit``
    and ``gradient``; both launch counts and both whole-cycle counts set
    to 0 just before and read just after.  ``compute`` with observed
    data leaves the simulation not computed, so ``misfit`` solves every
    task again, from its converged field (no cycle).  ``kernels`` must
    have been launched.  Returns (the stages, the launches through the
    wrappers, the simulation)."""
    from emg3d_tpu_torch import Simulation, solver

    sim = Simulation(survey.copy(), model,
                     **gridding_kw(shape_classes, parallel))
    check(sim.device == 'cuda', sim.device)
    grids = {sim.get_grid(*sf) for sf in sim._srcfreq}
    batched = parallel == "batch"
    nsolves = len(grids) if batched else len(sim._srcfreq)
    stages, rows = {}, None if batched else []
    kernel_counts(reset=True)
    solver.reset_counts()
    gridding_stage("compute", nsolves,
                   lambda: sim.compute(observed=True,
                                       rng=np.random.default_rng(20)),
                   stages, rows)
    its_f = task_iterations(sim, 'efield')
    gridding_stage("misfit and gradient", 2 * nsolves,
                   lambda: (sim.misfit, sim.gradient), stages, rows)
    its_b = task_iterations(sim, 'bfield')
    counts = kernel_counts()
    log(f"[gridding] {label}: {len(grids)} grids of "
        f"{len({g.shape_cells for g in grids})} shapes; (source, frequency, "
        f"it_ssl, it_mg) per grid shape, forward {its_f}, adjoint {its_b}; "
        f"launches through the wrappers "
        f"{({k: c[0] for k, c in counts.items()})}, plain calls on cuda "
        f"{({k: c[1] for k, c in counts.items()})}; cycle graphs: "
        f"{solver.CYCLE_CAPTURES} captures, {solver.CYCLE_REPLAYS} replays")
    for name, (launches, plain) in counts.items():
        check(launches > 0 or name not in kernels,
              (label, name, "not launched"))
        check(plain == 0, (label, name, "plain calls on CUDA", plain))
    return stages, {k: c[0] for k, c in counts.items()}, sim


def gridding_memory(stages, single):
    """The task loop's memory: per kind of solve (forward, adjoint) and
    grid, the running peak after the grid's first and after its last
    task (the loop visits a grid's tasks one after the other, one per
    source), beside ``single``, the peak of one solve on the largest
    grid, and after every task the memory still allocated, apart from
    what the step cache holds.  A grid's last task may raise the peak of
    its first by ``MEMORY_GROWTH`` at most."""
    for name, stage in stages.items():
        first, last = {}, {}
        for kind, shape, gid, peak, alloc, held, _ in stage["rows"]:
            first.setdefault((kind, gid), (shape, peak))
            last[(kind, gid)] = (shape, peak)
        log(f"[gridding memory] {name}: max_memory_allocated after each "
            f"grid's first and last task "
            f"{[(k[0], s, p, last[k][1]) for k, (s, p) in first.items()]} "
            f"B; after each task memory_allocated less what the step "
            f"cache holds {[r[4] - r[5] for r in stage['rows']]} B, the "
            f"step cache {[r[5] for r in stage['rows']]} B; one solve on "
            f"the largest grid {single} B; the stage's peak "
            f"{stage['peak']} B ({stage['peak'] / single:.3f}x)")
        for key, (shape, peak) in first.items():
            check(last[key][1] <= MEMORY_GROWTH * peak,
                  (name, key[0], shape, peak, last[key][1]))


def gridding_recipe(shape_classes, device=None, parallel="task", **opts):
    """The survey of tests/test_simulations.py::TestAutoGridding (16^3
    cells of 200 m, 1 Ohm m, two x-directed sources, two receivers) at
    0.5, 1 and 2 Hz with ``gridding='frequency'``, linear receiver
    interpolation, complex128 and the solver options ``opts``: synthetic
    data, then with the observed data 1.1 times them misfit and gradient
    (no forward solve again).  Returns (the simulation, {synthetic,
    misfit, gradient})."""
    from emg3d_tpu_torch import (Model, RxElectricPoint, Simulation, Survey,
                                 TensorMesh, TxElectricDipole)

    h = np.ones(16) * 200.0
    grid = TensorMesh([h, h, h], origin=(-1600.,) * 3)
    model = Model(grid, property_x=1.0, mapping='Resistivity')
    survey = Survey([TxElectricDipole((x, 0., -200., 0., 0.))
                     for x in (-300., 300.)],
                    [RxElectricPoint((x, 0., -250., 0., 0.))
                     for x in (600., 900.)], [0.5, 1.0, 2.0],
                    relative_error=0.05)
    sim = Simulation(survey, model, gridding='frequency',
                     shape_classes=shape_classes, parallel=parallel,
                     receiver_interpolation='linear', tqdm_opts=False,
                     verb=-1, device=device, solver_opts={
                         'dtype': torch.complex128, 'verb': 0, **opts})
    sim.compute()
    sim.data['observed'] = sim.data.synthetic * 1.1
    return sim, {"synthetic": np.asarray(sim.data.synthetic).copy(),
                 "misfit": sim.misfit, "gradient": sim.gradient.copy()}


# The small recipe's solver for the card against the CPU: its own, plain
# multigrid (V-cycles: on the CPU a cycle of the plain versions takes
# some 0.25 s on these grids, an F-cycle twice that).
RECIPE_PLAIN = {"plain": True, "cycle": "V", "tol": 1e-6}


def recipe_iterations(sim):
    """{(kind, source, frequency): (exit, it_mg)} of ``sim``'s tasks."""
    return {(which, src, freq): (info["exit"], info["it_mg"])
            for which in ("efield", "bfield")
            for src, freq in sim._srcfreq
            for info in [sim._dict_get(f"{which}_info", src, freq)]}


def cpu_recipe(classes):
    """``gridding_recipe`` on the CPU with ``RECIPE_PLAIN`` (in a worker
    process): (results, iterations)."""
    torch.set_num_threads(1)
    sim, res = gridding_recipe(classes, device="cpu", **RECIPE_PLAIN)
    check(sim.device == "cpu", sim.device)
    return res, recipe_iterations(sim)


def gridding_parity(cpu_runs):
    """At the small recipe (``gridding_recipe``), shape classes off and
    at 1.7: on the card the task loop against the batch engine with the
    default solver to tol 1e-10, and the card against the CPU
    (``cpu_runs``: {classes: future of ``cpu_recipe``}) with
    ``RECIPE_PLAIN``, the same ``it_mg`` per task; data, misfit and
    gradient to 1e-8 of the largest entry."""
    t0 = time.perf_counter()
    errs = {}
    for classes in (False, 1.7):
        task, task_res = gridding_recipe(classes, tol=1e-10, **PRODUCTION)
        batch, batch_res = gridding_recipe(classes, parallel="batch",
                                           tol=1e-10, **PRODUCTION)
        card, card_res = gridding_recipe(classes, **RECIPE_PLAIN)
        cpu_res, cpu_its = cpu_runs[classes].result()
        for sim in (task, batch):
            check_tasks(sim, "efield", 1e-10)
            check_tasks(sim, "bfield", 1e-10)
        check(card.device == "cuda", card.device)
        card_its = recipe_iterations(card)
        check(card_its == cpu_its and all(
            e == 0 for e, _ in card_its.values()), (card_its, cpu_its))
        for pair, a, b in (("batch vs task", batch_res, task_res),
                           ("card vs cpu", card_res, cpu_res)):
            errs[f"{pair}, shape_classes={classes}"] = {
                k: largest(a[k], b[k]) for k in b}
        shapes = {card.get_grid(*sf).shape_cells for sf in card._srcfreq}
        log(f"[gridding parity] small recipe, shape_classes={classes}: "
            f"grid shapes {sorted(shapes)}; (exit, it_mg) per task on card "
            f"and CPU {card_its}")
    log(f"[gridding parity] largest differences relative to the largest "
        f"entry: {errs} ({time.perf_counter() - t0:.1f} s)")
    for pair, err in errs.items():
        for name, e in err.items():
            check(e <= 1e-8, (pair, name, e))


def phase_frequency_gridding(n=128):
    """salt_128_frequency_gridding (``gridding_stages``), and
    ``gridding_parity`` at the small recipe, whose CPU side runs in
    worker processes while the card runs the survey.  Returns {path:
    {kernel: launches}}."""
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = {c: pool.submit(cpu_recipe, c) for c in (False, 1.7)}
        paths = gridding_stages(n)
        gridding_parity(cpu_runs)
    return paths


def gridding_stages(n):
    """salt_128_frequency_gridding: the task loop on whole-cycle graphs
    (shape classes off; the peak of one solve on the largest grid
    first, from an empty step cache), then the batch engine with shape
    classes; each ``compute``, then ``misfit`` and ``gradient``.  Checks
    convergence, the memory (``gridding_memory``) and that the step
    cache's states and level stores are what its steps hold.  Returns
    {path: {kernel: launches}}."""
    from emg3d_tpu_torch import Simulation, solver
    from emg3d_tpu_torch.parallel import tasks

    survey, model = gridding_survey(n)
    probe = gridding_kw(False)
    log(f"[gridding] salt_128_frequency_gridding: model {model.shape} "
        f"({model.grid.n_cells} cells), {survey.shape[0]} sources x "
        f"{survey.shape[1]} receivers x {survey.shape[2]} frequencies "
        f"{[round(f, 4) for f in GRIDDING_FREQUENCIES]} Hz; Simulation "
        f"keywords {probe}")

    # One solve on the largest grid, alone, from an empty step cache.
    sim = Simulation(survey, model, **probe)
    src = next(iter(survey.sources))
    big = max(survey.frequencies, key=lambda f: sim.get_grid(src, f).n_cells)
    solver._STEPS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, info = tasks.solve({
        "model": model, "grid": sim.get_grid(src, big),
        "source": survey.sources[src], "frequency": survey.frequencies[big],
        "efield": None, "solver_opts": probe["solver_opts"]})
    torch.cuda.synchronize()
    single = torch.cuda.max_memory_allocated()
    log(f"[gridding] one solve on the largest grid "
        f"{sim.get_grid(src, big).shape_cells} ({big}): "
        f"{time.perf_counter() - t0:.2f} s, it_ssl {info['it_ssl']}, it_mg "
        f"{info['it_mg']}, max_memory_allocated {single} B")
    check(info["exit"] == 0 and info["rel_error"] < 1e-6, info)
    del sim

    solver._STEPS.clear()       # the stage captures its own steps
    stages, task_launches, sim = gridding_engine(
        "task loop, shape classes off", survey, model, False, "task",
        ["gs_phase", "line_phase"])
    gridding_memory(stages, single)
    held = list(solver._STEPS.values())
    states = {id(s.state) for s in held}
    stores = {id(s) for h in held for s in (h.store, h.store2)
              if s is not None}
    log(f"[gridding] the step cache at the end: {len(held)} steps "
        f"(bound {solver._MAX_STEPS}), {step_cache_bytes()} B of states "
        f"and level stores, len(_STATES) {len(solver._STATES)} "
        f"({len(states)} held by steps), len(_STORES) "
        f"{len(solver._STORES)} ({len(stores)} held by steps)")
    check({id(s) for s in solver._STATES.values()} == states, "states")
    check({id(s) for s in solver._STORES.values()} == stores, "stores")
    check(solver.CYCLE_REPLAYS > solver.CYCLE_CAPTURES, "replays")
    gridding_results(sim)
    del sim

    # With shape classes every level of the three grid shapes has lines
    # to relax (the point smoother runs only on (2, 80, 2), a level of
    # (128, 80, 64), which the classes pad away): line_phase alone.
    stages_b, batch_launches, sim = gridding_engine(
        "batch engine, shape classes True", survey, model, GRIDDING_CLASSES,
        "batch", ["line_phase"])
    gridding_results(sim)
    del sim
    for label, st in (("task loop", stages), ("batch", stages_b)):
        total = sum(s["seconds"] for s in st.values())
        inside = sum(s["inside"] for s in st.values())
        log(f"[gridding] {label}: {total!r} s in all, "
            f"{100 * (1 - inside / total):.1f} % outside the solves")

    return {"salt_128_frequency_gridding": task_launches,
            "salt_128_frequency_gridding_batch": batch_launches}


def main():
    start = time.perf_counter()
    seconds, allocated = {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        before = torch.cuda.memory_allocated()
        gc.collect()        # what stays is held, not garbage in cycles
        allocated[name] = (before, torch.cuda.memory_allocated())
        return out

    smi, name = timed("card", phase_card)
    timed("build", phase_build)
    timed("fresh process", phase_fresh_graph_solve)
    problems = main_problems()
    gridding = timed("gridding grids", gridding_problems)
    (gs_shapes, line_shapes), (real_gs, real_line), gridding_line = timed(
        "levels", phase_path_levels, problems, gridding)
    del gridding
    gs_abs, gs_times, gs_bound = timed("gs_phase", phase_gs_vs_plain,
                                       gs_shapes, real_gs)
    ln_times, ln_bound = timed("line_phase times", line_phase_times)
    batched = timed("batched kernels", phase_batched_kernels, gs_shapes,
                    line_shapes)
    # The timed phases are done: the line checks run beside the rest.
    line_checks = start_line_checks(line_shapes, real_line, gridding_line)
    paths, main_refs, bicgstab = timed("main paths", phase_main_paths,
                                       problems)
    paths.update(timed("krylov variants", phase_krylov_variants,
                       problems["triaxial"], bicgstab))
    del bicgstab
    paths["salt_survey_128_8src"], survey_results = timed(
        "survey", phase_survey)
    timed("adjoint", phase_adjoint)
    timed("card vs cpu", phase_card_vs_cpu)
    timed("survey card vs cpu", phase_survey_card_vs_cpu)
    paths["solve_batch_triaxial_128_4freq"], batch_ref = timed(
        "solve_batch", phase_solve_batch, problems)
    timed("memory repeat", phase_memory_repeat, problems["triaxial"])
    paths.update(timed("multi-device", phase_multi_device, problems,
                       main_refs, batch_ref))
    del main_refs, batch_ref
    paths["salt_survey_128_8src_batch"] = timed(
        "survey batch", phase_survey_batch, survey_results)
    paths.update(timed("frequency gridding", phase_frequency_gridding))
    timed("inversion", phase_inversion)
    paths["cli_salt_128_8src"] = timed("cli", phase_cli, survey_results)
    paths["time_domain_64_128freq"] = timed("time domain",
                                            phase_time_domain)
    paths["laplace_triaxial_128"] = timed("laplace", phase_laplace,
                                          problems["laplace"])
    timed("examples", phase_examples)
    ln_abs = timed("line_phase checks", finish_line_checks, line_checks)
    log(f"[time] seconds per phase {seconds}; "
        f"{time.perf_counter() - start:.1f} s in all")
    log(f"[memory] memory_allocated after each phase, before and after "
        f"gc.collect() {allocated} B")
    garbage = {k: b - a for k, (b, a) in allocated.items()}
    log(f"[memory] left to the collector by each phase {garbage} B (limit "
        f"{GARBAGE_LIMIT} B)")
    for phase, nbytes in garbage.items():
        check(nbytes <= GARBAGE_LIMIT, ("garbage", phase, nbytes))
    measured = {"gs_phase": (gs_abs, gs_times, gs_bound),
                "line_phase": (ln_abs, ln_times, ln_bound)}
    record = {"kernels": [dict(
        name=k, route="cuda", source=KERNELS[k]["source"],
        replaces=KERNELS[k]["replaces"],
        launches=paths["triaxial_default_128"][k],
        max_abs_err=max(measured[k][0], batched[k][1]), ms=measured[k][1][0],
        plain_ms=measured[k][1][1], bound_ms=measured[k][2][0],
        bound_by=measured[k][2][1], library_ms=None,
        batched=batched[k][0],
        launches_by_path={p: c[k] for p, c in paths.items()})
        for k in KERNELS]}
    log(f"card: {smi}")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
