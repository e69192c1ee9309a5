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

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import importlib.util
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


def gs_phase_work(shape, color, item, ritem):
    """(bytes, flops) one point phase must move and do.

    Counted once each: the neighbouring edges the phase nodes read (12
    per node, shared between nodes), the 6 edges per node written and
    their sources read, the 8 cells around each node (3 eta of ``item``
    bytes, zeta of ``ritem``), and the widths.
    """
    nx, ny, nz = (len(range(1 + p, n, 2)) for n, p in zip(shape, color))
    nodes = nx * ny * nz
    read = (2 * nx * ((ny + 1) * nz + ny * (nz + 1))
            + 2 * ny * ((nx + 1) * nz + nx * (nz + 1))
            + 2 * nz * ((nx + 1) * ny + nx * (ny + 1)))
    cells = 8 * nodes
    nbytes = (item * (read + 2 * 6 * nodes + 3 * cells)
              + ritem * (cells + sum(shape)))
    return nbytes, GS_FLOPS_PER_NODE * nodes


def line_phase_work(shape, color, axis, item, ritem):
    """(bytes, flops, scratch bytes) of one line phase.

    Counted once each, in the frame of the lines (x along the line): the
    neighbouring edges the lines read, the 5 NX - 4 unknowns per line
    written and their sources read, the cells around the lines (3 eta
    of ``item`` bytes, zeta of ``ritem``) and the widths.  The block-
    Thomas scratch (``line_phase.SCRATCH_VALUES`` values per group,
    written and read back) is returned apart.
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
    nbytes = (item * (read + 2 * written + 3 * cells)
              + ritem * (cells + NX + NY + NZ))
    scratch = 2 * item * line_phase.SCRATCH_VALUES * lines * (NX - 1)
    return nbytes, LINE_FLOPS_PER_GROUP * lines * NX, scratch


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
                f"{info['error_at_cycle']}\n{info['log']}")
        check(info['exit'] == 0, (which, src, freq, info['exit_message']))
        check(info['rel_error'] < tol, (which, src, freq, info['rel_error']))
        its.append((info['it_ssl'], info['it_mg']))
    return its


def phase_survey(n=128, nsrc=8):
    """The salt-class ``n``^3 survey of ``nsrc`` sources.  Returns
    {kernel: launches} of the whole phase."""
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
    smi, name = phase_card()
    phase_build()
    problems = main_problems()
    gs_shapes, line_shapes = phase_path_levels(problems)
    gs_abs, gs_times, gs_bound = phase_gs_vs_plain(gs_shapes)
    ln_abs, ln_times, ln_bound = phase_line_vs_plain(line_shapes)
    paths = phase_main_paths(problems)
    paths["salt_survey_128_8src"] = phase_survey()
    phase_adjoint()
    phase_card_vs_cpu()
    phase_survey_card_vs_cpu()
    measured = {"gs_phase": (gs_abs, gs_times, gs_bound),
                "line_phase": (ln_abs, ln_times, ln_bound)}
    record = {"kernels": [dict(
        name=k, route="cuda", source=KERNELS[k]["source"],
        replaces=KERNELS[k]["replaces"],
        launches=paths["triaxial_default_128"][k],
        max_abs_err=measured[k][0], ms=measured[k][1][0],
        plain_ms=measured[k][1][1], bound_ms=measured[k][2][0],
        bound_by=measured[k][2][1], library_ms=None,
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
