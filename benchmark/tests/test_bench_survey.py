"""The survey cell (``marine_canonical_1hz.gradient``) on the CPU: a small
copy of it comes out correct and its control not; a receiver left out of
one adjoint source comes out not correct; the readers of the survey
layer's spans and counters (``benchmark/surveylog.py``) read a synthetic
span log, and nothing from a log that does not fit; the survey reference
loads neither the program nor JAX.

The small copy is ``small.py``'s (a 16^3 inversion mesh, the sources
scaled by 1/8) with no warm-up iterates, a computational grid of 12^3
cells (a 400 m least cell width, a 3 km buffer) and point smoothing in
V-cycles: the CPU solves the cell's line relaxation slowly."""

import itertools
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from emg3d_tpu_torch import electrodes, tracing

from benchmark import harness
from benchmark.tests.small import small

CELL = "marine_canonical_1hz.gradient"
READERS = ("survey.rfield_ms_per_step", "survey.model_ms_per_step",
           "survey.gradient_ms_per_step", "survey.solves_ms_per_step",
           "survey.rfield_receivers_per_step")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def run(tmp_path, control=False):
    workload, config = small(CELL)
    workload["traffic"]["warm_steps"] = 0
    config["simulation"]["gridding_opts"].update(
        max_buffer=3000, min_width_limits=400, stretching=[1.3, 1.5],
        cell_numbers=[8, 12, 16])
    config["solver"].update(linerelaxation=False, cycle="V", nu_pre=1,
                            nu_post=1)
    return harness.run_cell(CELL, 2 ** 31 + 11, 1, 0, "cpu",
                            time.perf_counter(), tmp_path,
                            workload=workload, config=config,
                            control=control)


def test_small_cell_correct_and_control_not(tmp_path):
    result, record = run(tmp_path, control=True)
    checks = result["checks"]
    assert result["correct"], checks
    assert record["checked"] >= 1 and result["attempted"] >= 1
    # Two forward and two adjoint solves an iterate.
    assert len(record["cycles"]) == 4 * result["attempted"]
    limits = {k: c["limit"] for k, c in checks.items()}
    assert any(record["control"][k] > limits[k] for k in limits), (
        record["control"], limits)


def test_receiver_left_out(monkeypatch, tmp_path):
    # The first receiver source field of the run adds nothing to its
    # adjoint source.
    adjoint = electrodes.RxElectricPoint._adjoint_source
    calls = itertools.count()

    def left_out(coordinates, strength):
        return adjoint(coordinates,
                       strength=0.0 if next(calls) == 0 else strength)

    monkeypatch.setattr(electrodes.RxElectricPoint, "_adjoint_source",
                        staticmethod(left_out))
    result, _ = run(tmp_path)
    checks = result["checks"]
    assert not result["correct"], checks
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in ("residual_adjoint", "gradient")), checks


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


@pytest.fixture
def span_log():
    """Two iterates' spans, as the survey layer logs them: each a root
    with two adjoint sources of 3 receivers, two task models and two
    outer solves, one with a solve nested in it."""
    tracing.clear()
    with tracing.recording():
        for _ in range(2):
            with tracing.span("emg3d.sim.gradient"):
                for _ in range(2):
                    with tracing.span("emg3d.sim.model"):
                        time.sleep(0.001)
                    with tracing.span("emg3d.solve"):
                        with tracing.span("emg3d.solve"):
                            time.sleep(0.001)
                    with tracing.span("emg3d.sim.rfield", receivers=3):
                        tracing.count("rfield_receivers", 3)
                with tracing.span("emg3d.sim.gradient.assemble"):
                    time.sleep(0.001)
    yield tracing.spans()
    tracing.clear()


def test_readers_read_a_span_log(span_log):
    record = {"profile": {"answers": 2}}
    got = {name: reader(name)(record) for name in READERS}

    def ms(name, outer=False):
        spans = [s for s in span_log if s.name == name and not (
            outer and s.parent is not None
            and any(p.id == s.parent and p.name == name for p in span_log))]
        return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / 2

    assert got["survey.rfield_receivers_per_step"] == 6
    assert got["survey.rfield_ms_per_step"] == pytest.approx(
        ms("emg3d.sim.rfield"))
    assert got["survey.model_ms_per_step"] == pytest.approx(
        ms("emg3d.sim.model"))
    assert got["survey.gradient_ms_per_step"] == pytest.approx(
        ms("emg3d.sim.gradient.assemble"))
    # The outer solves only: each holds its nested one.
    assert got["survey.solves_ms_per_step"] == pytest.approx(
        ms("emg3d.solve", outer=True))
    assert got["survey.solves_ms_per_step"] >= 2 * 1.0


@pytest.mark.parametrize("record", [{"profile": {"answers": 3}},
                                    {"profile": None}, {}])
def test_readers_read_nothing_else(span_log, record):
    assert all(reader(name)(record) is None for name in READERS)


def test_readers_read_no_solve_log(span_log):
    # Solves without the survey layer's roots, as the other cells log.
    tracing.clear()
    with tracing.recording():
        with tracing.span("emg3d.solve"):
            pass
    assert all(reader(name)({"profile": {"answers": 1}}) is None
               for name in READERS)


def test_reference_imports(tmp_path):
    code = ("import sys\nsys.path.insert(0, '.')\n"
            "import benchmark.reference.survey\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                               "HOME": str(tmp_path),
                               "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "emg3d_tpu",
                         "emg3d_tpu_torch"}, loaded
