"""One run of one cell: set-up, the measured window, the traced span and
the check against the plain reference.

A cell is ``workloads/<cell>.json``: its configuration (``config``, the
file ``configs/<config>.json``), the entry the window drives (``entry``,
the module ``entries/<entry>.py``), the traffic parameters the entry and
the configuration's builder (``builders/<builder>.py``) read, how many
answers the check samples (``check_sample``), how many steps the traced
run profiles (``trace_steps``) and the limit of each number the check
compares (``limits``).  Which metrics a cell reports, and their units,
is ``BENCHMARK.json``'s: an end-to-end metric without ``workloads`` is
every cell's, a per-layer metric without ``workloads`` is every cell's
that reports the metric it moves.  Each metric is read from the run's
record by ``metrics/<metric>.py``.  Nothing here names a cell or a
metric.
"""

import gc
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import devtrace, hooks, roofline

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "emg3d_tpu")
LINE_KERNEL = "line_phase_kernel"


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.parent.name + "_" + path.stem.replace(".", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(cell):
    """(workload, configuration) of a cell, as the files hold them."""
    with open(HERE / "workloads" / f"{cell}.json") as f:
        workload = json.load(f)
    with open(HERE / "configs" / f"{workload['config']}.json") as f:
        config = json.load(f)
    return workload, config


def load_spec():
    """``BENCHMARK.json`` of the checkout."""
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec, cell, kind):
    """The entries of ``spec[kind]`` (``"end_to_end"`` or
    ``"per_layer"``) that ``cell`` reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if cell in m.get(
        "workloads", [cell] if m["moves"] in reported else [])]


def read_metrics(cell, kind, record):
    """{name: {value, unit}} of the cell's metrics of ``kind`` that find
    something to read in ``record``."""
    metrics = {}
    for m in cell_metrics(load_spec(), cell, kind):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(
            record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


class Reservoir:
    """A uniform sample of at most ``k`` of a stream of answers, drawn
    with ``rng``: which answers the check compares."""

    def __init__(self, k, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info():
    """(name, power limit) of card 0, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


def _launch_counts():
    from emg3d_tpu_torch import solver
    from emg3d_tpu_torch.ops import gs_phase, line_phase
    return {"captures": solver.CYCLE_CAPTURES,
            "program_replays": solver.CYCLE_REPLAYS,
            "wrapper_launches": gs_phase.LAUNCHES + line_phase.LAUNCHES}


def line_bound_s(launches):
    """Least seconds of the recorded ``line_phase`` launches."""
    total, memo = 0.0, {}
    for launch in launches:
        if launch not in memo:
            (cells, axis, tasks, stacked, item, ritem), parity = launch
            nbytes, flops, _ = roofline.line_phase_work(
                cells, parity, axis, item, ritem, tasks, stacked)
            memo[launch] = roofline.bound_s(nbytes, flops)[0]
        total += memo[launch]
    return total


def _profiled_span(entry, tracer, steps, sync, chrome_path):
    """Run ``steps`` more steps under ``torch.profiler`` and reduce the
    trace (see :mod:`benchmark.devtrace`)."""
    from torch.profiler import ProfilerActivity, profile

    tracer.line_launches = []
    answers = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with hooks.StackSampler() as sampler:
            t_span = time.perf_counter()
            with torch.profiler.record_function(devtrace.SPAN):
                tracer.recording = True
                for i in range(steps):
                    answers += entry.step(-1 - i, lambda item: None)
                sync()
                tracer.recording = False
    prof.export_chrome_trace(str(chrome_path))
    summary = devtrace.summarize(
        devtrace.load(chrome_path),
        [(t - t_span, label) for t, label in sampler.samples])
    if summary is None:
        return None
    line = [v for k, v in summary["by_name"].items() if LINE_KERNEL in k]
    summary["answers"] = answers
    summary["line_phase"] = {
        "traced": sum(v[0] for v in line),
        "device_s": sum(v[1] for v in line),
        "recorded": len(tracer.line_launches),
        "bound_s": line_bound_s(tracer.line_launches),
    }
    return summary


def run_cell(cell, seed, seconds, trace, device, t_start, out_dir,
             workload=None, config=None, control=False):
    """Run one cell once; returns the result line (a dict) and the
    record the metrics read.  ``workload`` and ``config``
    replace the cell's files (the tests run small copies on the CPU).
    ``control``: also read the check's numbers with the control in the
    program's place (see ``Entry.control``)."""
    if workload is None:
        workload, config = load_cell(cell)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)
    build = load_module(HERE / "builders" / f"{config['builder']}.py").build
    inputs = build(config, workload["traffic"], rng)
    tracer = None
    if trace:
        tracer = hooks.Tracer()
        tracer.install()
    Entry = load_module(HERE / "entries" / f"{workload['entry']}.py").Entry
    entry = Entry(inputs, config, workload["traffic"], device, rng)
    entry.warm()
    sync()
    entry.cycles, entry.failed = [], 0

    before = _launch_counts()
    replays0 = tracer.replays if tracer else 0
    sample = Reservoir(workload["check_sample"], rng)
    steps = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        ts = time.perf_counter()
        mark = len(tracer.inside) if tracer else 0
        answers = entry.step(len(steps), sample.offer)
        sync()
        te = time.perf_counter()
        steps.append({"wall": te - ts, "answers": answers,
                      "inside": sum(tracer.inside[mark:]) if tracer
                      else None})
        if te - t0 >= seconds:
            break
    window_s = te - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    after = _launch_counts()
    attempted = sum(s["answers"] for s in steps)
    record = {
        "cell": cell, "seed": seed, "steps": steps, "answers": attempted,
        "window_s": window_s, "setup_s": setup_s,
        "peak_bytes": peak, "cycles": list(entry.cycles),
        "failed": entry.failed, **{k: after[k] - before[k] for k in after},
        "replays": None,
    }

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if tracer:
        record["replays"] = tracer.replays - replays0
        record["profile"] = (
            _profiled_span(entry, tracer, workload["trace_steps"], sync,
                           out_dir / f"{cell}.{seed}.chrome.json")
            if cuda else None)
        tracer.uninstall()
    record["card"] = card_info() if cuda else "cpu"

    # The reference runs once the window has closed, the peak has been
    # read and the program's state is freed.
    kept = sample.items
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = workload["limits"]
    values = entry.check(kept, device)
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    record["checked"] = len(kept)
    if control:
        record["control"] = entry.check([entry.control(x) for x in kept],
                                        device)

    correct = (entry.failed == 0 and len(kept) > 0 and all(
        not math.isnan(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": workload["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted,
              "failed": entry.failed}
    result["metrics"] = read_metrics(
        cell, "per_layer" if trace else "end_to_end", record)
    if trace:
        prof = record["profile"]
        if prof is not None:
            device_info["busy_s"] = prof["busy_s"]
            device_info["window_s"] = prof["window_s"]
            result["breakdown"] = {
                "device_ops": devtrace.top(
                    {k: v[1] for k, v in prof["by_name"].items()}),
                "idle_gaps": devtrace.top(prof["idle"]),
            }
    result["device"] = device_info
    result["checks"] = checks

    with open(out_dir / f"{cell}.{seed}.trace{int(bool(trace))}.json",
              "w") as f:
        json.dump({"result": result, "record": record}, f, default=str)
    return result, record


def report(result, record):
    """The earlier lines of a run, on standard output."""
    walls = [s["wall"] for s in record["steps"]]
    print(f"[benchmark] {record['cell']} seed {record['seed']}: card "
          f"{record['card']}")
    print(f"[benchmark] set-up {record['setup_s']!r} s; window "
          f"{record['window_s']!r} s, {len(walls)} steps, "
          f"{record['answers']} answers, {record['failed']} not converged")
    print(f"[benchmark] step seconds {walls!r}")
    print(f"[benchmark] cycles (it_mg) per answer {record['cycles']!r}")
    print(f"[benchmark] in the window: {record['captures']} captures, "
          f"{record['replays']} replays seen by the hook "
          f"({record['program_replays']} by solver.CYCLE_REPLAYS), "
          f"{record['wrapper_launches']} "
          f"launches through the kernels' wrappers")
    prof = record.get("profile")
    if prof:
        print(f"[benchmark] traced span {prof['window_s']!r} s, busy "
              f"{prof['busy_s']!r} s, {prof['answers']} answers, H2D "
              f"{prof['h2d_s']!r} s; line_phase {prof['line_phase']!r}")
    if "control" in record:
        print(f"[benchmark] control readings {record['control']!r}")


def report_checks(result):
    """Each number compared, beside its limit: the last lines of standard
    error."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
