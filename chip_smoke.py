"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one card, imports nothing of JAX.
Phases (any failure raises, and the script exits non-zero):

1. Card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
2. Build: the ``gs_phase`` kernel from ``emg3d_tpu_torch/csrc`` with nvcc.
3. Kernel against its plain PyTorch version on the card, on every level
   shape of the 128^3 hierarchy and a stretched odd shape, all colors and
   one full sweep; complex128 to 1e-12 and complex64 to 1e-5 norm-wise
   (real float64/float32 too); per-phase times at 128^3 and 64^3.
4. The main path: the BASELINE recipe (1 Ohm m fullspace, x-directed
   dipole at the origin, 1 Hz, 50 m cells, plain F-cycles to tol 1e-6) at
   128^3 and 256^3 through ``emg3d_tpu_torch.solve(..., device='cuda')``
   in complex64, checking convergence and that every smoothing phase went
   through the kernel.
5. A 32^3 stretched anisotropic solve in complex128 on the card (kernel)
   and on the CPU (plain version): same cycles, fields to 1e-10.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GS_SOURCE = "emg3d_tpu_torch/csrc/gs_phase.cu"
GS_REPLACES = ("emg3d_tpu/ops/pallas_gs.py:452 (gauss_seidel_phase_pallas); "
               "emg3d_tpu/ops/pallas_gs.py:663 "
               "(gauss_seidel_phase_pallas_tiled)")


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


def hierarchy_shapes(n):
    shapes = [(n, n, n)]
    while n > 2:
        n //= 2
        shapes.append((n, n, n))
    return shapes


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
    # (~4 zeta / h^2) are of one size: neither dominates the 6x6 systems.
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
    _build.load("gs_phase")
    log(f"[build] gs_phase.cu: nvcc {_build.BUILD_SECONDS['gs_phase']:.2f} s"
        f" (load incl. {time.perf_counter() - t0:.2f} s), flags "
        f"{' '.join(_build.NVCC_FLAGS)}")


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


def phase_kernel_vs_plain():
    from emg3d_tpu_torch.ops import smoothers

    plain = smoothers._gauss_seidel_phase_torch
    kernel = smoothers.gauss_seidel_phase
    cases = [(torch.complex128, torch.float64, 1e-12),
             (torch.complex64, torch.float32, 1e-5)]
    shapes = hierarchy_shapes(128) + [(37, 50, 29)]
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
        log(f"[kernel] {shape}: all colors + sweep agree "
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
    log("[kernel] float64/float32 (37, 50, 29): all colors agree")

    times = {}
    for n in (128, 64):
        args = operands((n, n, n), torch.complex64, torch.float32, seed=n)
        k_ev, k_dev = time_phase(kernel, args, (0, 0, 0), 50)
        p_ev, p_dev = time_phase(plain, args, (0, 0, 0), 10)
        times[n] = (k_dev or k_ev, p_dev or p_ev)
        log(f"[kernel] phase time {n}^3 complex64 (ms per phase): kernel "
            f"{k_ev!r} on the stream, {k_dev!r} device; plain {p_ev!r} on "
            f"the stream, {p_dev!r} device")
    return max_abs_c64, times


def baseline_problem(n):
    from emg3d_tpu_torch import Model, TensorMesh, get_source_field

    h = np.full(n, 50.0)
    grid = TensorMesh([h, h, h], origin=(-n * 25.0,) * 3)
    model = Model(grid, property_x=1.0)
    sfield = get_source_field(grid, source=(0., 0., 0., 0., 0.),
                              frequency=1.0)
    return model, sfield


def solve_baseline(model, sfield):
    from emg3d_tpu_torch import solve

    return solve(model, sfield, plain=True, cycle='F', tol=1e-6, maxit=50,
                 return_info=True, device='cuda')


def phase_main_path():
    from emg3d_tpu_torch.ops import gs_phase

    launches = None
    for n in (128, 256):
        model, sfield = baseline_problem(n)
        if n == 128:
            solve_baseline(model, sfield)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gs_phase.reset_counts()
        t0 = time.perf_counter()
        efield, info = solve_baseline(model, sfield)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_launch, n_plain = gs_phase.LAUNCHES, gs_phase.PLAIN_CALLS_ON_CUDA
        if n == 128:
            launches = n_launch
        errs = info['error_at_cycle']
        factor = (errs[-1] / errs[0]) ** (1.0 / max(info['it_mg'], 1))
        field = np.asarray(efield.field)
        log(f"[solve] {n}^3 BASELINE complex64: {dt:.3f} s, "
            f"{n ** 3 / dt:.0f} cells/s, it_mg {info['it_mg']}, rel_error "
            f"{info['rel_error']:.3e}, mean reduction/cycle {factor:.3f}, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
            f"gs_phase launches {n_launch}, plain calls on cuda {n_plain}")
        check(info['exit'] == 0, info['exit_message'])
        check(info['it_mg'] <= 8, info['it_mg'])
        check(info['rel_error'] < 1e-6, info['rel_error'])
        check(n_launch > 0 and n_plain == 0, (n_launch, n_plain))
        check(field.shape == (sfield.field.size,))
        check(np.all(np.isfinite(field)) and np.abs(field).max() > 0)
    return launches


def phase_card_vs_cpu():
    from emg3d_tpu_torch import Model, TensorMesh, get_source_field, solve

    rng = np.random.default_rng(32)
    h = [rng.uniform(40.0, 120.0, 32) for _ in range(3)]
    grid = TensorMesh(h, origin=(-1000.0, -1200.0, -900.0))
    shape = grid.shape_cells
    model = Model(grid, property_x=rng.uniform(1, 3, shape),
                  property_y=rng.uniform(1, 4, shape),
                  property_z=rng.uniform(2, 6, shape),
                  mapping='Resistivity')
    sfield = get_source_field(grid, (0., 0., 0., 20., 10.), 0.77)
    kw = dict(plain=True, cycle='F', tol=1e-6, return_info=True,
              dtype=torch.complex128)
    t0 = time.perf_counter()
    ef_gpu, inf_gpu = solve(model, sfield, device='cuda', **kw)
    t1 = time.perf_counter()
    ef_cpu, inf_cpu = solve(model, sfield, device='cpu', **kw)
    t2 = time.perf_counter()
    a = torch.from_numpy(np.asarray(ef_gpu.field))
    b = torch.from_numpy(np.asarray(ef_cpu.field))
    err = rel_err(a, b)
    log(f"[parity] 32^3 stretched triaxial complex128: card it_mg "
        f"{inf_gpu['it_mg']} ({t1 - t0:.2f} s), cpu it_mg "
        f"{inf_cpu['it_mg']} ({t2 - t1:.2f} s), field rel diff {err:.2e}")
    check(inf_gpu['exit'] == 0 and inf_cpu['exit'] == 0)
    check(inf_gpu['it_mg'] == inf_cpu['it_mg'])
    check(err <= 1e-10, err)


def main():
    smi, name = phase_card()
    phase_build()
    max_abs, times = phase_kernel_vs_plain()
    launches = phase_main_path()
    phase_card_vs_cpu()
    record = {"kernels": [{
        "name": "gs_phase", "route": "cuda", "source": GS_SOURCE,
        "replaces": GS_REPLACES, "launches": launches,
        "max_abs_err": max_abs, "ms": times[128][0],
        "plain_ms": times[128][1]}]}
    log(f"card: {smi}")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
