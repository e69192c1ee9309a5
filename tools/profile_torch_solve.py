"""Where the time of one solve of the PyTorch port goes, on one CUDA card.

    python3 -m tools.profile_torch_solve [triaxial|baseline|marine] [n]

Solves one north-star problem through ``emg3d_tpu_torch.solve`` (after a
warm-up solve at 32 cells a side) under ``torch.profiler`` and prints:
the wall time, the device time of every kernel and copy summed by name
(count, ms), the device busy time and the idle share 1 - busy / wall.

- ``triaxial``: n^3 fullspace, rho 1/2/5 Ohm m, the default solver;
- ``baseline``: n^3 fullspace, 1 Ohm m, plain F-cycles;
- ``marine``: n x n x n/2 layered marine model, sc+lr F-cycles.

The problems and their options are those of ``emg3d_tpu_torch.northstar``.
Run from the repo root; imports nothing of JAX; needs a card.
"""

import collections
import subprocess
import sys
import time

import torch

from emg3d_tpu_torch import northstar


def main():
    case = sys.argv[1] if len(sys.argv) > 1 else "triaxial"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from emg3d_tpu_torch import solve

    make = getattr(northstar, f"{case}_problem")
    kw = northstar.SOLVE_OPTIONS[case]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    solve(*make(32), tol=1e-6, **kw)                  # warm-up
    model, sfield = make(n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = solve(model, sfield, tol=1e-6, return_info=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in by_name.values())
    print(f"card: {smi}")
    print(f"{case} {model.shape}: wall {wall!r} s under the profiler, "
          f"it_ssl {info['it_ssl']}, it_mg {info['it_mg']}, rel_error "
          f"{info['rel_error']!r}, {info['exit_message']}")
    print(f"device busy {busy!r} ms in {sum(v[0] for v in by_name.values())}"
          f" kernels and copies; idle share {1 - busy / (1e3 * wall)!r}")
    for name, (count, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:15]:
        print(f"  {ms:10.3f} ms  {count:7d}  {name[:100]}")


if __name__ == "__main__":
    main()
