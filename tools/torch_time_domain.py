"""North-star configuration 5 with the PyTorch port at several box sizes.

    python3 -m tools.torch_time_domain [n ...] [--device cpu]

Runs ``emg3d_tpu_torch.northstar.time_domain(n)`` (tools/bench_time.py's
recipe: a 1 Ohm m fullspace of n^3 cells of 100 m, one plain F-cycle
solve per frequency ``Fourier`` needs between 1e-3 and 100 Hz, the
transient at 900 m) for each ``n`` (default 64 96 128: boxes of 6.4,
9.6 and 12.8 km), on the card unless ``--device cpu``.  Prints per box
the wall time, the iterations and exit messages of its solves, the
relative error of the transient against the closed form
(tests/alternatives.fullspace_dipole_time) per time and the largest over
the filter's core (times 1-9) beside tools/bench_time.py's limit 0.15.
Run from the repo root; imports nothing of JAX.
"""

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from emg3d_tpu_torch import northstar

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tests"))
import alternatives  # noqa: E402

LIMIT = 0.15    # tools/bench_time.py's ``ok``


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", nargs="*", type=int, default=[64, 96, 128])
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    if args.device is None:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)

    times, offset = np.logspace(-2, 1, 13), 900.0
    exact = alternatives.fullspace_dipole_time(
        np.array([[offset, 0., 0.]]), (0., 0., 0.), times, 1.0,
        signal=-1)[:, 0, 0]
    rows = []
    for n in args.sizes:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        transient, per_freq = northstar.time_domain(
            n, times=times, offset=offset, device=args.device)
        wall = time.perf_counter() - t0
        err = np.abs(transient - exact) / np.abs(exact)
        core = float(err[1:10].max())
        its = [p["it_mg"] for p in per_freq]
        messages = sorted({p["exit_message"] for p in per_freq})
        print(f"[time domain] {n}^3 ({n * 0.1:g} km box), {len(per_freq)} "
              f"frequencies: {wall!r} s; it_mg {min(its)}-{max(its)}; exit "
              f"messages {messages}; relative error per time "
              f"{[float(f'{e:.4g}') for e in err]}; largest over the core "
              f"(times 1-9) {core!r} at "
              f"{float(times[1 + int(err[1:10].argmax())])!r} s (limit "
              f"{LIMIT}, met: {core < LIMIT})", flush=True)
        rows.append((n, core))
    print(f"[time domain] largest core error per box {rows}")


if __name__ == "__main__":
    main()
