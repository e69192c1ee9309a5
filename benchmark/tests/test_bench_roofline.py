"""The frozen work counts and the reduction of a profiler trace."""

import json

import pytest

from benchmark import devtrace, harness, roofline


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_line_phase_bytes_as_chip_smoke_logs(axis):
    # chip_smoke.py logs 125828608 B (bound 0.037560778507462686 ms) for
    # a 128^3 complex64 line phase of colour (0, 0), along every axis.
    nbytes, flops, scratch = roofline.line_phase_work(
        (128, 128, 128), (0, 0), axis, 8, 4)
    assert (nbytes, flops, scratch) == (125828608, 1048576000, 249692160)
    assert roofline.bound_s(nbytes, flops) == pytest.approx(
        (0.037560778507462686e-3, "bytes"), rel=1e-12)


def test_gs_phase_bytes_as_chip_smoke_logs():
    nbytes, flops = roofline.gs_phase_work((128, 128, 128), (0, 0, 0), 8, 4)
    assert (nbytes, flops) == (109446656, 314572800)
    assert roofline.bound_s(nbytes, flops)[0] == pytest.approx(
        0.032670643582089556e-3, rel=1e-12)


def test_batched_counts():
    # Eight tasks on a shared eta with a per-task scale (chip_smoke.py's
    # batched counts); stacked eta adds the other seven tasks' eta.
    assert roofline.line_phase_work((128,) * 3, (0, 0), 0, 8, 4, 8) == (
        595576384, 8388608000, 1997537280)
    assert roofline.gs_phase_work((128,) * 3, (0, 0, 0), 8, 4, 8) == (
        464520768, 2516582400)
    shared = roofline.line_phase_work((16,) * 3, (0, 1), 2, 8, 4, 3)[0]
    stacked = roofline.line_phase_work((16,) * 3, (0, 1), 2, 8, 4, 3,
                                       stacked=True)[0]
    cells = 16 * 2 * 8 * 2 * 7
    assert stacked - shared == 8 * (3 * 2 * cells - 3)


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_summary_of_a_synthetic_trace(tmp_path):
    events = [
        _ev("user_annotation", devtrace.SPAN, 100.0, 1000.0),
        _ev("cpu_op", "aten::copy_", 150.0, 100.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 160.0, 20.0),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200.0, 50.0,
            tid=7),
        _ev("kernel", "line_phase_kernel<c10::complex<float>>", 400.0,
            200.0, tid=7),
        _ev("kernel", "other", 500.0, 200.0, tid=7),   # overlaps: once
        _ev("cuda_runtime", "cudaGraphLaunch", 350.0, 10.0),
        _ev("kernel", "outside", 1200.0, 100.0, tid=7),
        _ev("cpu_op", "other thread", 800.0, 100.0, tid=2),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = devtrace.summarize(devtrace.load(path))
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(350e-6)     # 50 + 300, clipped
    assert s["h2d_s"] == pytest.approx(50e-6)
    assert s["by_name"]["line_phase_kernel<c10::complex<float>>"] == (
        1, pytest.approx(200e-6))
    # Idle 650 us, by the innermost host event open on the span's thread:
    # aten::copy_ 100 less its runtime call (20) and its copy (50), the
    # runtime call 20, the graph launch 10, and 590 outside any operator.
    assert s["idle"] == pytest.approx({
        "aten::copy_": 30e-6, "cudaMemcpyAsync": 20e-6,
        "cudaGraphLaunch": 10e-6, devtrace.HOST_ONLY: 590e-6})
    assert sum(s["idle"].values()) + s["busy_s"] == pytest.approx(1000e-6)
    assert devtrace.top(s["idle"], 1) == [[devtrace.HOST_ONLY,
                                           pytest.approx(590e-6)]]

    # Samples of the program's stack (seconds from the span's start) split
    # the time outside any operator: a piece that holds samples shares
    # its time among them, one without goes to the nearest sample.
    samples = [(180e-6, "solver._build_hierarchy"),
               (800e-6, "fields.get_receiver")]
    s = devtrace.summarize(devtrace.load(path), samples)
    assert s["idle"] == pytest.approx({
        "aten::copy_": 30e-6, "cudaMemcpyAsync": 20e-6,
        "cudaGraphLaunch": 10e-6, "solver._build_hierarchy": 190e-6,
        "fields.get_receiver": 400e-6})


def test_metric_readers_on_a_record():
    record = {
        "steps": [{"wall": 2.0, "inside": 0.5, "answers": 1},
                  {"wall": 3.0, "inside": 1.5, "answers": 1}],
        "answers": 2, "window_s": 5.0, "setup_s": 12.5,
        "peak_bytes": 3 * 2 ** 30, "cycles": [7, 8], "replays": 14,
        "wrapper_launches": 10,
        "profile": {"window_s": 2.0, "busy_s": 0.5, "h2d_s": 0.1,
                    "answers": 2,
                    "line_phase": {"traced": 4, "recorded": 4,
                                   "device_s": 0.2, "bound_s": 0.05}},
    }
    readers = {p.stem: harness.load_module(p)
               for p in (harness.HERE / "metrics").glob("*.py")}
    got = {k: r.read(record) for k, r in readers.items()}
    assert got["setup_s"] == 12.5
    assert got["solve_s"] == pytest.approx(2.5)
    assert got["peak_mem_GiB"] == pytest.approx(3.0)
    assert got["solver.cycles_per_solve"] == pytest.approx(7.5)
    assert got["hierarchy.h2d_ms_per_solve"] == pytest.approx(50.0)
    assert got["cycle_graph.replays_per_solve"] == pytest.approx(7.0)
    assert got["batch.wrapper_launches_per_solve"] == pytest.approx(5.0)
    assert got["line_phase_roofline"] == pytest.approx(25.0)
    assert got["device.idle_share.solve"] == pytest.approx(0.75)
    # A mismatch of launches and traced kernels reads nothing.
    record["profile"]["line_phase"]["recorded"] = 3
    assert readers["line_phase_roofline"].read(record) is None
    record["profile"] = None
    assert readers["device.idle_share.solve"].read(record) is None
    assert readers["hierarchy.h2d_ms_per_solve"].read(record) is None


def test_stack_sampler_names_the_program_function():
    import time

    import numpy as np

    from benchmark import hooks
    from emg3d_tpu_torch import meshes

    with hooks.StackSampler(period=0.001) as sampler:
        end = time.perf_counter() + 0.3
        while time.perf_counter() < end:
            meshes.TensorMesh([np.ones(64)] * 3, origin=(0, 0, 0))
    labels = {label for _, label in sampler.samples}
    assert any(label.startswith("meshes.") for label in labels), labels
    times = [t for t, _ in sampler.samples]
    assert times == sorted(times) and len(times) > 10
