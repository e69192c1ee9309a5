"""Where the time of one solve of the PyTorch port goes, on one CUDA card.

    python3 -m tools.profile_torch_solve [triaxial|baseline|marine|salt|batch] [n]

Solves one north-star problem through ``emg3d_tpu_torch.solve`` (after a
warm-up solve at 32 cells a side) under ``torch.profiler`` and prints:
the wall time, the device time of every kernel and copy summed by name
(count, ms), the device busy time and the idle share 1 - busy / wall.

- ``triaxial``: n^3 fullspace, rho 1/2/5 Ohm m, the default solver;
- ``baseline``: n^3 fullspace, 1 Ohm m, plain F-cycles;
- ``marine``: n x n x n/2 layered marine model, sc+lr F-cycles.

``salt`` is the survey path (``northstar.salt_survey(n, 8)`` through
``emg3d_tpu_torch.Simulation``): the whole forward pass, then misfit and
gradient on the model whose salt is 0.8 times as resistive, each with its
wall time, the time inside and outside ``solve`` and the host functions
that take most of it (``cProfile``, own time); then one forward task
under ``torch.profiler`` as for the other cases.

``batch`` is the batch engine: the ``triaxial`` problem's source at 0.25,
0.5, 1 and 2 Hz as one ``solve_batch_fields`` call (the default solver's
options given in full), under ``torch.profiler`` as above.

The problems and their options are those of ``emg3d_tpu_torch.northstar``.
Run from the repo root; imports nothing of JAX; needs a card.
"""

import collections
import cProfile
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

from emg3d_tpu_torch import northstar


def host_stage(label, nsolves, fn):
    """Run ``fn`` (a stage of a survey) under ``cProfile``; print its wall
    time, the time inside and outside ``solve`` and the host functions
    with the most time of their own."""
    with northstar.timed_solves() as inside:
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        fn()
        prof.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"{label}: wall {wall!r} s under cProfile for {len(inside)} solves "
          f"(expected {nsolves}), {sum(inside)!r} s inside solve, "
          f"{wall - sum(inside)!r} s ({100 * (1 - sum(inside) / wall):.1f} %) "
          f"outside it")
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (fname, line, func), (_, ncalls, own, cum, _) in rows:
        print(f"  {own:9.3f} s own {cum:9.3f} s cumulative {ncalls:7d} calls"
              f"  {fname.rsplit('/', 1)[-1]}:{line}({func})")


def salt_task(n):
    """The survey stages under ``cProfile``; returns a function that solves
    one forward task again, and a label."""
    from emg3d_tpu_torch import Simulation

    survey, model, kw = northstar.salt_survey(n, 8)
    kw['tqdm_opts'] = False
    sim = Simulation(survey, model, **kw)
    host_stage("salt forward pass", 8, lambda: sim.compute(
        observed=True, rng=np.random.default_rng(20)))
    sim2 = Simulation(sim.survey.copy(), northstar.salt_model(
        model.grid, salt_scale=0.8), **kw)
    host_stage("salt misfit and gradient", 16, lambda: sim2.gradient)
    sim.clean('computed')

    def task():
        sim.compute(source='TxEP-1', frequency='f-1')
        return sim.get_efield_info('TxEP-1', 'f-1')

    return task, f"salt {model.shape}, the forward task of source 1"


def batch_task(n):
    """One batched solve of four frequencies (after a warm-up at 32^3);
    returns it as a function, and a label."""
    from emg3d_tpu_torch import get_source_field, solve_batch_fields

    freqs = (0.25, 0.5, 1.0, 2.0)
    opts = dict(sslsolver=True, semicoarsening=True, linerelaxation=True,
                tol=1e-6)

    def sources(model):
        return [get_source_field(model.grid, (0., 0., 0., 0., 0.), f)
                for f in freqs]

    small, _ = northstar.triaxial_problem(32)
    solve_batch_fields(small, sources(small), **opts)      # warm-up
    model, _ = northstar.triaxial_problem(n)
    sfields = sources(model)

    def task():
        _, info = solve_batch_fields(model, sfields, **opts)
        return {'it_ssl': info['it_ssl'], 'it_mg': info['it_mg'],
                'rel_error': float(info['rel_error'].max()),
                'exit_message': sorted(set(info['exit_messages']))}

    return task, f"triaxial {model.shape} x {len(freqs)} frequencies, batched"


def main():
    case = sys.argv[1] if len(sys.argv) > 1 else "triaxial"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from emg3d_tpu_torch import solve

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    if case == "salt":
        solve(*northstar.triaxial_problem(32), tol=1e-6)    # warm-up
        task, label = salt_task(n)
    elif case == "batch":
        task, label = batch_task(n)
    else:
        make = getattr(northstar, f"{case}_problem")
        kw = northstar.SOLVE_OPTIONS[case]
        solve(*make(32), tol=1e-6, **kw)                  # warm-up
        model, sfield = make(n)
        label = f"{case} {model.shape}"

        def task():
            return solve(model, sfield, tol=1e-6, return_info=True, **kw)[1]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        info = task()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in by_name.values())
    print(f"{label}: wall {wall!r} s under the profiler, "
          f"it_ssl {info['it_ssl']}, it_mg {info['it_mg']}, rel_error "
          f"{info['rel_error']!r}, {info['exit_message']}")
    print(f"device busy {busy!r} ms in {sum(v[0] for v in by_name.values())}"
          f" kernels and copies; idle share {1 - busy / (1e3 * wall)!r}")
    for name, (count, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:15]:
        print(f"  {ms:10.3f} ms  {count:7d}  {name[:100]}")


if __name__ == "__main__":
    main()
