"""Time and check the ``line_phase`` kernel alone, on one CUDA card.

    python3 -m tools.time_torch_phase [--compare NAME ...] [--quick]

The quick loop for an edit of ``emg3d_tpu_torch/csrc/line_phase.cu``:
well under a minute, against the ten minutes of ``chip_smoke.py``.  It
builds the kernel and prints

1. the ``-Xptxas -v`` registers and spills of every instantiation, and
   from ``cuobjdump -sass`` the instruction count of every loop of every
   instantiation (the forward and the backward pass);
2. the norm-wise difference from the plain version
   (``smoothers._line_relax_phase_torch``) on the entries it changed, one
   shape per axis plus a long and a 2-group line, every color, in
   complex64 and complex128;
3. per phase, in complex64, color (0, 0), axes 0/1/2, at 128^3, 64^3,
   (128, 64, 32) and (2, 128, 2): ms on the stream (CUDA events over 50
   back-to-back calls of the one-call wrapper, and over 50 launches of one
   plan), device ms (``torch.profiler``), host ms of the wrapper and of
   ``LinePlan.launch`` alone (``time.perf_counter`` around the call with no
   synchronisation, mean of 200), and the bound from the byte count of
   ``chip_smoke.line_phase_work``;
4. per launch within ``smoothers.gauss_seidel_line`` (nu = 2, one plan for
   its 8 phases) at 128^3: ms on the stream and device ms;
5. where the host time of the one-call wrapper goes: the 13 checks, the
   frame geometry, the strides through permuted views, the scratch
   ``torch.empty``, the pointers, the stream lookup, the device context,
   the plan as a whole and the bare ``ctypes`` launch.

``--compare NAME`` also builds ``csrc/NAME.cu`` (another version of the
kernel with the same C interface and scratch size) and times all in turns
within this one call (first, second, second, first), since device times
of separate calls are not comparable.  The other build exists in this
tool alone: it is swapped into a plan that the tool owns.  ``--quick``
stops after step 2.

Run from the repo root; imports nothing of JAX; needs a card.
"""

import argparse
import collections
import ctypes
import pathlib
import re
import subprocess

import torch

import chip_smoke
from emg3d_tpu_torch.ops import _build, _operands, line_phase, smoothers

CHECK_SHAPES = {0: [(48, 10, 12), (128, 4, 2)], 1: [(10, 48, 12), (2, 64, 2)],
                2: [(12, 10, 48)]}
TIME_SHAPES = [(128, 128, 128), (64, 64, 64), (128, 64, 32), (2, 128, 2)]


def plan_of(source, tensors, axis):
    """A plan that launches the build ``source``: the package's own plan,
    with the entry point of ``csrc/<source>.cu`` in place of its own."""
    plan = line_phase.LinePlan(*tensors, axis)
    if source != "line_phase":
        entry = plan._fn.__name__
        fn = getattr(_build.load(source), entry)
        fn.argtypes, fn.restype = plan._fn.argtypes, plan._fn.restype
        plan._fn = fn
    return plan


def phase_fn(source):
    """The one-call wrapper of the build ``source``."""
    def fn(*args):
        *tensors, p1, p2, axis = args
        plan_of(source, tensors, axis).launch(p1, p2)
    return fn


def loop_counts(source):
    """Print the instructions of each loop of each kernel of the build
    ``source``, from ``cuobjdump -sass`` (a loop: a backward branch)."""
    lib = pathlib.Path(_build.load(source)._name)
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], text=True,
                          capture_output=True, check=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"^\s+/\*([0-9a-f]{4,5})\*/\s+(.*?);", func, re.M)]
        print(f"[sass] {source} {func.split()[0][-32:]}: {len(ins)} "
              f"instructions", flush=True)
        for addr, text in ins:
            m = re.search(r"BRA\S*\s+.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                ops = collections.Counter(
                    re.sub(r"^@!?U?P\d+\s+", "", t).split()[0].split(".")[0]
                    for t in body)
                print(f"[sass]   loop of {len(body)}: "
                      f"{ops.most_common(8)}", flush=True)


def check(sources):
    plain = smoothers._line_relax_phase_torch
    cases = [(torch.complex64, torch.float32, 1e-6),
             (torch.complex128, torch.float64, 1e-12)]
    for axis, shapes in CHECK_SHAPES.items():
        for shape in shapes:
            for dtype, rdt, tol in cases:
                base = chip_smoke.operands(shape, dtype, rdt, seed=5)
                colors = smoothers.line_phase_colors(shape, axis, False)
                refs = []
                for color in colors:
                    ref = [t.clone() for t in base]
                    plain(*ref, *color, axis)
                    refs.append(ref)
                for source in sources:
                    worst = 0.0
                    for color, ref in zip(colors, refs):
                        out = [t.clone() for t in base]
                        phase_fn(source)(*out, *color, axis)
                        torch.cuda.synchronize()
                        err, _ = chip_smoke.updated_err(out, ref, base)
                        worst = max(worst, err)
                        for a, b, c in zip(out[:3], ref[:3], base[:3]):
                            keep = b == c
                            chip_smoke.check(
                                torch.equal(a[keep], c[keep]),
                                (source, shape, axis, color, "untouched"))
                    print(f"[check] {source} {shape} axis {axis} {dtype}: "
                          f"{len(colors)} colors, worst {worst:.3e} "
                          f"(tol {tol:g})", flush=True)
                    chip_smoke.check(worst <= tol, (source, shape, axis))


def time_one(source, args, axis):
    """Readings of one build at one shape and axis, color (0, 0)."""
    wrapper = phase_fn(source)
    plan = plan_of(source, args, axis)
    w_ev, w_dev = chip_smoke.time_phase(wrapper, args, (0, 0, axis), 50)
    p_ev, p_dev = chip_smoke.time_phase(
        lambda *a: plan.launch(0, 0), (), (), 50)
    return dict(
        stream_wrapper=w_ev, stream_plan=p_ev, device=p_dev,
        device_wrapper=w_dev,
        host_wrapper=chip_smoke.host_ms(lambda: wrapper(*args, 0, 0, axis)),
        host_launch=chip_smoke.host_ms(lambda: plan.launch(0, 0)))


def timings(sources):
    order = sources + sources[::-1] if len(sources) > 1 else sources
    for shape in TIME_SHAPES:
        args = chip_smoke.operands(shape, torch.complex64, torch.float32,
                                   seed=sum(shape))
        for axis in (0, 1, 2):
            nbytes, flops, scratch = chip_smoke.line_phase_work(
                shape, (0, 0), axis, 8, 4)
            b_ms, b_by = chip_smoke.bound_ms(nbytes, flops)
            for source in order:
                r = time_one(source, args, axis)
                print(f"[time] {source} {shape} axis {axis} complex64 (ms "
                      f"per phase): device {r['device']!r}; on the stream "
                      f"{r['stream_plan']!r} from one plan, "
                      f"{r['stream_wrapper']!r} through the one-call "
                      f"wrapper; host {r['host_launch']!r} per "
                      f"plan.launch, {r['host_wrapper']!r} per wrapper "
                      f"call; bound {b_ms!r} ({b_by}: {nbytes} B, {flops} "
                      f"flop; scratch apart {scratch} B)", flush=True)


def smoothing_call():
    """Per launch within gauss_seidel_line (nu = 2) at 128^3."""
    shape = (128, 128, 128)
    args = chip_smoke.operands(shape, torch.complex64, torch.float32, seed=1)
    for axis in (0, 1, 2):
        before = line_phase.LAUNCHES
        ev, dev = chip_smoke.time_phase(
            smoothers.gauss_seidel_line, args, (2, axis), 10)
        # time_phase calls 1 + 10 + 10 times.
        per_call = (line_phase.LAUNCHES - before) // 21
        print(f"[smoothing] gauss_seidel_line nu=2 {shape} axis {axis} "
              f"complex64: {per_call} launches per call; per launch "
              f"{ev / per_call!r} ms on the stream, "
              f"{(dev or float('nan')) / per_call!r} ms device", flush=True)


def breakdown():
    """Where the host time of one wrapper call goes (ms, mean of 200)."""
    shape, axis = (128, 128, 128), 0
    args = chip_smoke.operands(shape, torch.complex64, torch.float32, seed=2)
    ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta, hx, hy, hz = args
    device, dt, rdt = ex.device, ex.dtype, hx.dtype
    nx, ny, nz = shape
    shx, shy, shz = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                     (nx + 1, ny + 1, nz))
    named = [("ex", ex, shx, dt), ("ey", ey, shy, dt), ("ez", ez, shz, dt),
             ("sx", sx, shx, dt), ("sy", sy, shy, dt), ("sz", sz, shz, dt),
             ("eta_x", eta_x, shape, dt), ("eta_y", eta_y, shape, dt),
             ("eta_z", eta_z, shape, dt), ("zeta", zeta, shape, rdt),
             ("hx", hx, (nx,), rdt), ("hy", hy, (ny,), rdt),
             ("hz", hz, (nz,), rdt)]
    tp = line_phase.FRAMES[axis]
    plan = line_phase.LinePlan(*args, axis)
    nscratch = plan._scratch.numel()

    def checks():
        for name, t, shp, d in named:
            _operands._check("line_phase", name, t, device, d, shp)

    def geometry():
        frame, strides, _ = line_phase.line_geometry(
            shape, (ex.stride(), ey.stride(), ez.stride(), zeta.stride()),
            axis)
        return (ctypes.c_int64 * 20)(*frame, *strides, 0, 0, 0, 0, 0)

    def device_context():
        with torch.cuda.device(device):
            pass

    pieces = [
        ("13 checks", checks),
        ("frame geometry and geo array", geometry),
        ("strides through 4 permuted views",
         lambda: [t.permute(tp).stride() for t in (ex, ey, ez, zeta)]),
        ("scratch torch.empty",
         lambda: torch.empty(nscratch, dtype=dt, device=device)),
        ("14 pointers (view_as_real, data_ptr)",
         lambda: [_operands.ptr(t) for t in (*args, plan._scratch)]),
        ("stream lookup",
         lambda: torch.cuda.current_stream(device).cuda_stream),
        ("torch.cuda.device context", device_context),
        ("LinePlan(...) as a whole",
         lambda: line_phase.LinePlan(*args, axis)),
        ("plan.launch (ctypes call, error check, count)",
         lambda: plan.launch(0, 0)),
        ("one-call wrapper as a whole",
         lambda: line_phase.gauss_seidel_line_phase_cuda(*args, 0, 0, axis)),
    ]
    for what, fn in pieces:
        print(f"[host] {what}: {chip_smoke.host_ms(fn)!r} ms", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", metavar="NAME", nargs="+", default=[],
                    help="also build and time csrc/NAME.cu")
    ap.add_argument("--quick", action="store_true",
                    help="build and check only")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    sources = ["line_phase", *opts.compare]
    for source in sources:
        _build.load(source)
        print(f"[build] {source}.cu: nvcc "
              f"{_build.BUILD_SECONDS.get(source, 0.0):.2f} s; ptxas:\n"
              f"{_build.PTXAS_INFO.get(source, '(reused build)')}",
              flush=True)
        loop_counts(source)
    check(sources)
    if opts.quick:
        return
    timings(sources)
    smoothing_call()
    breakdown()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; SM clock now and at most: {clocks}")


if __name__ == "__main__":
    main()
