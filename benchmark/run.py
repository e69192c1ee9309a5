"""Run one cell of the benchmark of emg3d_tpu_torch once, on the card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S
                             --trace {0,1} [--out DIR]

Prints earlier lines (card, per-step seconds, iterations, captures in
the window), then one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` (each number compared with its limit,
also the last lines of standard error).  Per-run details and the traced
run's chrome trace go to ``--out`` (default ``benchmark/out``).  Exits
with 2, printing no result, without a CUDA card (or fewer than the cell
asks for), without the program in this checkout, or with JAX or the JAX
package loaded.  See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=int, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", default=str(CHECKOUT / "benchmark" / "out"))
    args = parser.parse_args(argv)

    sys.path.insert(0, str(CHECKOUT))
    import json

    import torch

    from benchmark import harness

    def fail(message):
        print(f"benchmark: {message}", file=sys.stderr)
        return 2

    workload, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: no CUDA card")
    if torch.cuda.device_count() < workload["chips"]:
        return fail(f"{torch.cuda.device_count()} CUDA card(s), the cell "
                    f"asks for {workload['chips']}")
    try:
        import emg3d_tpu_torch
    except ImportError as err:
        return fail(f"the program is not in this checkout: {err}")
    where = pathlib.Path(emg3d_tpu_torch.__file__).resolve()
    if CHECKOUT not in where.parents:
        return fail(f"emg3d_tpu_torch imported from {where}, not from "
                    f"{CHECKOUT}")

    result, record = harness.run_cell(
        args.workload, args.seed, args.seconds, args.trace, "cuda", T_START,
        args.out)
    harness.report(result, record)
    found = harness.forbidden_modules()
    if found:
        return fail(f"loaded after the window: {', '.join(found)}")
    print(json.dumps(result), flush=True)
    harness.report_checks(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
