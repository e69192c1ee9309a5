"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one card, imports nothing of JAX.
Phases (any failure raises, and the script exits non-zero):

1. Card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
2. Build: both kernels from ``emg3d_tpu_torch/csrc`` (``gs_phase`` and
   ``line_phase``), one ``nvcc`` each, started together; nvcc seconds
   and the ``-Xptxas -v`` registers and spills of every instantiation.
3. The level shapes of the main paths (6 below), read from the
   hierarchies the solver builds for them: every level whose effective
   line-relaxation direction is 0 runs ``gs_phase``, every other level
   ``line_phase`` along the axes that direction names.
4. ``gs_phase`` against its plain PyTorch version on the card, on every
   ``gs_phase`` shape of the main paths and a stretched odd shape, all
   colors and one full sweep; complex128 to 1e-12 and complex64 to 1e-5
   norm-wise on the changed entries (real float64/float32 too); per-phase
   times at 128^3 and 64^3.
5. ``line_phase`` against its plain PyTorch version on the card: axes 0,
   1 and 2 on every level shape of the default solve's three 128^3
   semicoarsening hierarchies (sc_dir 1, 2, 3) and on (37, 50, 29), and
   every other ``line_phase`` shape of the main paths along the axes the
   path relaxes there; every color and one forward-plus-reverse sweep,
   complex128 to 1e-12 and complex64 to 1e-6, four times the error
   measured, so that a lost digit shows (float64/float32 once, on the
   odd shape, to the same).
   The plain version is bound by its host (some 16,000 launches per
   phase), so the shapes are shared out over worker processes, which end
   with the phase.  Then per-phase times at 128^3 and 64^3, with the host
   time of the wrapper alone.
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
   no call of a plain version on CUDA.
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
   inside it).
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
13. The salt survey through both engines at 64^3 (8 sources, so 8
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

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import importlib.util
import itertools
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
KERNELS = {
    "gs_phase": {
        "source": "emg3d_tpu_torch/csrc/gs_phase.cu",
        "replaces": ("emg3d_tpu/ops/pallas_gs.py:452 "
                     "(gauss_seidel_phase_pallas); "
                     "emg3d_tpu/ops/pallas_gs.py:663 "
                     "(gauss_seidel_phase_pallas_tiled)")},
    "line_phase": {
        "source": "emg3d_tpu_torch/csrc/line_phase.cu",
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


def phase_path_levels(problems):
    """The kernels' shapes on the main paths: ({shape} of ``gs_phase``,
    {shape: axes} of ``line_phase``) to hold against the plain versions.
    """
    from emg3d_tpu_torch import northstar

    odd = (37, 50, 29)
    gs, line = {odd}, {odd: {0, 1, 2}}
    for case, problem in problems.items():
        shapes, p_gs, p_line = path_levels(
            problem, northstar.SOLVE_OPTIONS[case])
        log(f"[levels] {case} {problem[0].shape}: gs_phase on "
            f"{sorted(p_gs)}; line_phase on "
            f"{sorted((s, sorted(a)) for s, a in p_line.items())}")
        gs |= p_gs
        for shape, axes in p_line.items():
            line.setdefault(shape, set()).update(axes)
        if case == "triaxial":
            # Every level shape of the default solve: all three axes.
            for shape in shapes:
                line.setdefault(shape, set()).update((0, 1, 2))
    check(gs and line, "no kernel on the main paths")
    bysize = dict(key=lambda s: (-int(np.prod(s)), s))
    return (sorted(gs, **bysize),
            {s: sorted(line[s]) for s in sorted(line, **bysize)})


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


def phase_gs_vs_plain(shapes):
    from emg3d_tpu_torch.ops import smoothers

    plain = smoothers._gauss_seidel_phase_torch
    kernel = smoothers.gauss_seidel_phase
    cases = [(torch.complex128, torch.float64, 1e-12),
             (torch.complex64, torch.float32, 1e-5)]
    log(f"[gs_phase] {len(shapes)} shapes: {shapes}")
    worst = {}
    max_abs_c64 = 0.0
    for shape in shapes:
        for dtype, rdt, tol in cases:
            base = operands(shape, dtype, rdt, seed=sum(shape))
            for color in smoothers.phase_colors(shape, False):
                ref = [t.clone() for t in base]
                out = [t.clone() for t in base]
                plain(*ref, *color)
                kernel(*out, *color)
                torch.cuda.synchronize()
                err, mabs = updated_err(out, ref, base)
                check(err <= tol, (shape, dtype, color, err))
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if dtype == torch.complex64:
                    max_abs_c64 = max(max_abs_c64, mabs)
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
        log(f"[gs_phase] {shape}: all colors + sweep agree "
            f"(worst so far c128 {worst[torch.complex128]:.2e}, "
            f"c64 {worst[torch.complex64]:.2e})")

    # Real (Laplace-domain) instantiations on the odd shape.
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        base = operands((37, 50, 29), dtype, dtype, seed=7)
        for color in smoothers.phase_colors((37, 50, 29), False):
            ref = [t.clone() for t in base]
            out = [t.clone() for t in base]
            plain(*ref, *color)
            kernel(*out, *color)
            torch.cuda.synchronize()
            err, _ = updated_err(out, ref, base)
            check(err <= tol, (dtype, color, err))
    log("[gs_phase] float64/float32 (37, 50, 29): all colors agree")

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
    return max_abs_c64, times[128], bound


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


# Worker processes of the line checks: half the 8 cores of a one-card
# host, since each worker's plain version keeps one core busy issuing
# launches and its CUDA runtime threads and the parent want the rest.
# Measured on such a host with an H100: the 36 shapes take 340 s in one
# process and 89-96 s in 4, whose workers end within 20 s of one another.
LINE_WORKERS = 4


def line_check_shapes(shapes):
    """Hold ``line_phase`` against its plain version on ``shapes``
    ({shape: axes}); runs in a worker process or in the caller's.
    Returns ({dtype name: worst norm-wise error}, max abs error in
    complex64)."""
    from emg3d_tpu_torch.ops import smoothers

    plain = smoothers._line_relax_phase_torch
    kernel = smoothers.gauss_seidel_line_phase
    colors = smoothers.line_phase_colors
    cases = [(torch.complex128, torch.float64, 1e-12),
             (torch.complex64, torch.float32, 1e-6)]
    worst = {}
    max_abs_c64 = 0.0
    t0 = time.perf_counter()
    for shape, axes in shapes.items():
        for dtype, rdt, tol in cases:
            base = operands(shape, dtype, rdt, seed=sum(shape) + 1)
            for axis in axes:
                for color in colors(shape, axis, False):
                    err, mabs = _line_compare(
                        plain, kernel, base, [(*color, axis)], tol,
                        (shape, dtype, axis, color))
                    worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
                    if dtype == torch.complex64:
                        max_abs_c64 = max(max_abs_c64, mabs)
                sweep = [(*c, axis) for rev in (False, True)
                         for c in colors(shape, axis, rev)]
                err, _ = _line_compare(plain, kernel, base, sweep, tol,
                                       (shape, dtype, axis, "sweep"))
                worst[str(dtype)] = max(worst[str(dtype)], err)
        log(f"[line_phase] {shape} axes {axes}: all colors and sweeps agree "
            f"(worst of this worker so far c128 "
            f"{worst['torch.complex128']:.2e}, c64 "
            f"{worst['torch.complex64']:.2e}; "
            f"{time.perf_counter() - t0:.1f} s)")
    return worst, max_abs_c64


def phase_line_vs_plain(shapes):
    """``shapes``: {shape: the axes to check there}."""
    import multiprocessing

    from emg3d_tpu_torch.ops import smoothers

    plain = smoothers._line_relax_phase_torch
    kernel = smoothers.gauss_seidel_line_phase
    colors = smoothers.line_phase_colors
    log(f"[line_phase] {len(shapes)} shapes: "
        f"{[(s, a) for s, a in shapes.items()]}")
    # Deal the shapes (largest first) round the workers: the cost of the
    # plain version follows the length and number of a shape's lines.
    chunks = [dict(list(shapes.items())[i::LINE_WORKERS])
              for i in range(LINE_WORKERS)]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            LINE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(line_check_shapes, chunks))
    worst = {k: max(r[0].get(k, 0.0) for r in results)
             for k in ("torch.complex128", "torch.complex64")}
    max_abs_c64 = max(r[1] for r in results)
    log(f"[line_phase] all {len(shapes)} shapes agree: worst c128 "
        f"{worst['torch.complex128']:.2e}, c64 "
        f"{worst['torch.complex64']:.2e} ({LINE_WORKERS} worker processes, "
        f"{time.perf_counter() - t0:.1f} s)")

    # Real (Laplace-domain) instantiations on the odd shape.
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        base = operands((37, 50, 29), dtype, dtype, seed=9)
        errs = [_line_compare(plain, kernel, base, [(*color, axis)], tol,
                              (dtype, axis, color))[0]
                for axis in (0, 1, 2)
                for color in colors((37, 50, 29), axis, False)]
        log(f"[line_phase] {dtype} (37, 50, 29): all axes and colors agree "
            f"(worst {max(errs):.2e}, tol {tol:g})")

    times, bound = {}, None
    for n in (128, 64):
        args = operands((n, n, n), torch.complex64, torch.float32, seed=n)
        for axis in (0, 1, 2):
            k_ev, k_dev = time_phase(kernel, args, (0, 0, axis), 50)
            k_host = host_ms(lambda: kernel(*args, 0, 0, axis))
            p_ev, p_dev = time_phase(plain, args, (0, 0, axis), 2)
            nbytes, flops, scratch = line_phase_work(
                (n, n, n), (0, 0), axis, 8, 4)
            b_ms, b_by = bound_ms(nbytes, flops)
            log(f"[line_phase] phase time {n}^3 complex64 axis {axis} (ms "
                f"per phase): kernel {k_ev!r} on the stream, {k_dev!r} "
                f"device, {k_host!r} host time of the wrapper alone; plain "
                f"{p_ev!r} on the stream, {p_dev!r} device; "
                f"bound {b_ms!r} ({b_by}: {nbytes} B, {flops} flop; "
                f"scratch apart {scratch} B)")
            if n == 128 and axis == 0:
                times = (k_dev or k_ev, p_dev or p_ev)
                bound = (b_ms, b_by)
    return max_abs_c64, times, bound


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


def drive(label, problem, kernels, **kw):
    """Solve ``problem`` through ``emg3d_tpu_torch.solve`` with every
    launch count set to 0 just before and read just after; check that it
    converged through each kernel of ``kernels`` and called no plain
    version on CUDA.  Returns {kernel: launches}."""
    from emg3d_tpu_torch import solve

    model, sfield = problem
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    efield, info = solve(model, sfield, return_info=True, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_counts()
    cells = int(np.prod(model.shape))
    field = np.asarray(efield.field)
    log(f"[solve] {label} {model.shape}: {dt!r} s, {cells / dt:.0f} "
        f"cells/s, it_ssl {info['it_ssl']}, it_mg {info['it_mg']}, "
        f"rel_error {info['rel_error']!r}, {info['exit_message']}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"launches {({k: c[0] for k, c in counts.items()})}, plain calls "
        f"on cuda {({k: c[1] for k, c in counts.items()})}")
    check(info['exit'] == 0, (label, info['exit_message']))
    check(info['rel_error'] < 1e-6, (label, info['rel_error']))
    for name in kernels:
        check(counts[name][0] > 0, (label, name, "not launched"))
    check(all(c[1] == 0 for c in counts.values()), (label, counts))
    check(field.shape == (sfield.field.size,))
    check(np.all(np.isfinite(field)) and np.abs(field).max() > 0)
    return {k: c[0] for k, c in counts.items()}


def main_problems():
    """The main paths' problems: {case: (model, sfield)}."""
    from emg3d_tpu_torch import northstar

    return {"baseline": northstar.baseline_problem(128),
            "triaxial": northstar.triaxial_problem(128),
            "marine": northstar.marine_problem(128)}


def phase_main_paths(problems):
    from emg3d_tpu_torch import northstar, solve

    opts = northstar.SOLVE_OPTIONS
    # Warm-up of both paths at a small size (first-call costs).
    solve(*northstar.baseline_problem(32), tol=1e-6, **opts["baseline"])
    solve(*northstar.triaxial_problem(32), tol=1e-6, **opts["triaxial"])
    plain = drive("BASELINE plain F-cycles", problems["baseline"],
                  ["gs_phase"], tol=1e-6, **opts["baseline"])
    check(plain["line_phase"] == 0, plain)
    default = drive("triaxial default solver", problems["triaxial"],
                    ["gs_phase", "line_phase"], tol=1e-6,
                    **opts["triaxial"])
    marine = drive("marine sc+lr F-cycles", problems["marine"],
                   ["line_phase"], tol=1e-6, **opts["marine"])
    return {"baseline_plain_128": plain, "triaxial_default_128": default,
            "marine_sclr_128x128x64": marine}


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
    from emg3d_tpu_torch import Simulation, northstar

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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    stages = {}

    def stage(name, nsolves, fn):
        with northstar.timed_solves() as inside:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        check(len(inside) == nsolves, (name, len(inside), nsolves))
        stages[name] = (dt, sum(inside))
        log(f"[survey] {name}: {dt!r} s for {nsolves} solves, {dt / nsolves!r}"
            f" s per solve, {cells * nsolves / dt:.0f} cells x solves / s; "
            f"{sum(inside)!r} s inside solve (smallest {min(inside)!r}, "
            f"largest {max(inside)!r}), {100 * (1 - sum(inside) / dt):.1f} % "
            f"outside it")
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
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
        f"launches {({k: c[0] for k, c in counts.items()})} "
        f"({({k: c[0] // nsolves for k, c in counts.items()})} per solve), "
        f"plain calls on cuda {({k: c[1] for k, c in counts.items()})}")
    for name, (launches, plain) in counts.items():
        check(launches > 0, (name, "not launched on the survey path"))
        check(plain == 0, (name, "plain calls on CUDA", plain))
    results = {"synthetic": synthetic, "observed": observed.copy(),
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
    return {k: c[0] for k, c in counts.items()}


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
    """The salt survey at ``n``^3 with ``nsrc`` sources, 8 lanes per
    batch, through both engines at the 128^3 phases' tol 1e-6 and at
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
    log(f"[survey batch] salt survey {n}^3 x {nsrc} sources (8 lanes), "
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
# engines, 8 lanes, to 1e-5 where both solve to 1e-9: the check that
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
    from emg3d_tpu_torch import Simulation, northstar

    survey_tolerance_witness()
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
        with northstar.timed_solves() as inside:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        check(len(inside) == nbatches, (name, len(inside), nbatches))
        stages[name] = (dt, sum(inside))
        log(f"[survey batch] {name}: {dt!r} s, {nbatches} batched solve(s) "
            f"of {nsrc} lanes, {sum(inside)!r} s inside them "
            f"({[round(t, 3) for t in inside]}), "
            f"{100 * (1 - sum(inside) / dt):.1f} % outside")
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
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
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


def main():
    start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    smi, name = timed("card", phase_card)
    timed("build", phase_build)
    problems = main_problems()
    gs_shapes, line_shapes = timed("levels", phase_path_levels, problems)
    gs_abs, gs_times, gs_bound = timed("gs_phase", phase_gs_vs_plain,
                                       gs_shapes)
    ln_abs, ln_times, ln_bound = timed("line_phase", phase_line_vs_plain,
                                       line_shapes)
    batched = timed("batched kernels", phase_batched_kernels, gs_shapes,
                    line_shapes)
    paths = timed("main paths", phase_main_paths, problems)
    paths["salt_survey_128_8src"], survey_results = timed(
        "survey", phase_survey)
    timed("adjoint", phase_adjoint)
    timed("card vs cpu", phase_card_vs_cpu)
    timed("survey card vs cpu", phase_survey_card_vs_cpu)
    paths["solve_batch_triaxial_128_4freq"] = timed(
        "solve_batch", phase_solve_batch, problems)
    paths["salt_survey_128_8src_batch"] = timed(
        "survey batch", phase_survey_batch, survey_results)
    log(f"[time] seconds per phase {seconds}; "
        f"{time.perf_counter() - start:.1f} s in all")
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
