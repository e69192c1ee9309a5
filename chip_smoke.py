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

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import json
import pathlib
import subprocess
import sys
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


def drive(label, problem, kernels, **kw):
    """Solve ``problem`` through ``emg3d_tpu_torch.solve`` with every
    launch count set to 0 just before and read just after; check that it
    converged through each kernel of ``kernels`` and called no plain
    version on CUDA.  Returns {kernel: launches}."""
    from emg3d_tpu_torch import solve
    from emg3d_tpu_torch.ops import gs_phase, line_phase

    mods = {"gs_phase": gs_phase, "line_phase": line_phase}
    model, sfield = problem
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.reset_counts()
    t0 = time.perf_counter()
    efield, info = solve(model, sfield, return_info=True, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: (m.LAUNCHES, m.PLAIN_CALLS_ON_CUDA)
              for k, m in mods.items()}
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


def main():
    smi, name = phase_card()
    phase_build()
    problems = main_problems()
    gs_shapes, line_shapes = phase_path_levels(problems)
    gs_abs, gs_times, gs_bound = phase_gs_vs_plain(gs_shapes)
    ln_abs, ln_times, ln_bound = phase_line_vs_plain(line_shapes)
    paths = phase_main_paths(problems)
    phase_card_vs_cpu()
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
