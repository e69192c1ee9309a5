"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload CELL --seeds N [N ...]
                                 --seconds S [--out DIR]

Runs the cell once per seed in this one process (set-up, a window of
``S`` seconds, the check) and prints one JSON line per seed: the
numbers the check compares for the program (``program``) and for the
control put in its place (``control``: see each entry's ``control``).
The benchmark's own runs do not run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=int, required=True)
    parser.add_argument("--out", default=str(CHECKOUT / "benchmark" / "out"))
    args = parser.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    t_start = T_START
    for seed in args.seeds:
        result, record = harness.run_cell(
            args.workload, seed, args.seconds, 0, "cuda", t_start, args.out,
            control=True)
        print(json.dumps({
            "seed": seed, "correct": result["correct"],
            "answers": record["answers"], "checked": record["checked"],
            "program": {k: v["value"] for k, v in result["checks"].items()},
            "control": record["control"],
            "setup_s": record["setup_s"],
            "step_s": [s["wall"] for s in record["steps"]],
            "cycles": record["cycles"],
            "peak_bytes": result["device"]["memory_peak_bytes"]}),
            flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
