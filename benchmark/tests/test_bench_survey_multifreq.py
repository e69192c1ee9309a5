"""The multi-frequency survey cell (``marine_canonical_3freq.forward``) on
the CPU: a small copy of it comes out correct and its control not; a
field solved at another frequency, and responses taken from another
frequency's field and grid, come out not correct; the readers of the
survey layer's grid and model counters (``benchmark/surveyroots.py``)
read a small recorded run and a synthetic log of either kind of step,
and nothing from a log without the counters.

The small copy is ``small.py``'s (a 16^3 inversion mesh, the sources
scaled by 1/8) with no warm-up steps and, per frequency, a least cell
width of one skin depth in the sea: grids of 10^3, 12^3 and 16^3 cells
at 0.25, 0.75 and 1.25 Hz.  Point smoothing in V-cycles: the CPU solves
the cell's line relaxation slowly."""

import time

import numpy as np
import pytest
import torch

from emg3d_tpu_torch import simulations, tracing
from emg3d_tpu_torch.parallel import tasks

from benchmark import harness
from benchmark.tests.small import small

CELL = "marine_canonical_3freq.forward"
SEED = 2 ** 31 + 13
READERS = ("survey.grid_ms_per_step", "survey.grids_per_step",
           "survey.models_per_step")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_cell():
    workload, config = small(CELL)
    workload["traffic"]["warm_steps"] = 0
    config["simulation"]["gridding_opts"].update(
        max_buffer=3000, min_width_pps=1, min_width_limits=[200, 700],
        stretching=[1.3, 1.5], cell_numbers=[8, 10, 12, 16])
    config["solver"].update(linerelaxation=False, cycle="V", nu_pre=1,
                            nu_post=1)
    return workload, config


def run(tmp_path, control=False):
    workload, config = small_cell()
    return harness.run_cell(CELL, SEED, 1, 0, "cpu", time.perf_counter(),
                            tmp_path, workload=workload, config=config,
                            control=control)


def failed(checks, *names):
    return any(checks[k]["value"] > checks[k]["limit"] for k in names)


def test_small_cell_correct_and_control_not(tmp_path):
    result, record = run(tmp_path, control=True)
    checks = result["checks"]
    assert result["correct"], checks
    assert record["checked"] >= 1 and result["attempted"] >= 1
    # Two sources at three frequencies a step.
    assert len(record["cycles"]) == 6 * result["attempted"]
    limits = {k: c["limit"] for k, c in checks.items()}
    assert any(record["control"][k] > limits[k] for k in limits), (
        record["control"], limits)


def test_field_at_another_frequency(monkeypatch, tmp_path):
    # Every task of the last frequency is solved at the first.
    solve = tasks.solve

    def wrong_frequency(inp):
        if inp.get("frequency") == 1.25:
            inp = {**inp, "frequency": 0.25}
        return solve(inp)

    monkeypatch.setattr(tasks, "solve", wrong_frequency)
    result, _ = run(tmp_path)
    assert not result["correct"], result["checks"]
    assert failed(result["checks"], "residual_forward"), result["checks"]


def test_responses_from_another_frequency(monkeypatch, tmp_path):
    # The responses of the second frequency are read from the first
    # frequency's field, on its grid.
    responses = simulations.Simulation._responses

    def other_grid(self, source, frequency, efield):
        if frequency == "f-2":
            frequency = "f-1"
            efield = self._dict_get("efield", source, frequency)
        return responses(self, source, frequency, efield)

    monkeypatch.setattr(simulations.Simulation, "_responses", other_grid)
    result, _ = run(tmp_path)
    assert not result["correct"], result["checks"]
    assert failed(result["checks"], "responses", "misfit"), result["checks"]


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def read_all(record):
    return {name: reader(name)(record) for name in READERS}


def test_readers_read_a_recorded_step():
    workload, config = small_cell()
    rng = np.random.default_rng(SEED)
    build = harness.load_module(
        harness.HERE / "builders" / f"{config['builder']}.py").build
    inputs = build(config, workload["traffic"], rng)
    Entry = harness.load_module(
        harness.HERE / "entries" / f"{workload['entry']}.py").Entry
    entry = Entry(inputs, config, workload["traffic"], "cpu", rng)
    entry.warm()
    tracing.clear()
    with tracing.recording():
        assert entry.step(0, lambda answer: None) == 1
    try:
        spans = tracing.spans()
        grids = [s for s in spans if s.name == "emg3d.sim.grid"]
        assert [s.attrs["shape"] for s in grids] == [
            (10, 10, 10), (12, 12, 12), (16, 16, 16)]
        got = read_all({"profile": {"answers": 1}})
        assert got["survey.grids_per_step"] == 3.0
        assert got["survey.models_per_step"] == 6.0
        assert got["survey.grid_ms_per_step"] == pytest.approx(
            1e-6 * sum(s.end_ns - s.start_ns for s in grids))
        # Another count of answers, no profile, no record of one.
        for record in ({"profile": {"answers": 2}}, {"profile": None}, {}):
            assert set(read_all(record).values()) == {None}
        # A program without the counters (the roots' counts lack them).
        for root in spans:
            if root.parent is None:
                root.attrs["counts"].pop("sim_grids")
                root.attrs["counts"].pop("sim_models")
        assert set(read_all({"profile": {"answers": 1}}).values()) == {None}
    finally:
        tracing.clear()


@pytest.fixture
def logged():
    """Two steps of each kind, as the survey layer logs them: an iterate
    (a gradient root around a compute with one grid and two task
    models, then two adjoint task models) and a forward evaluation (a
    compute root with three grids and six task models, then a misfit
    root)."""
    def log(kind):
        tracing.clear()
        with tracing.recording():
            for _ in range(2):
                if kind == "gradient":
                    with tracing.span("emg3d.sim.gradient"):
                        with tracing.span("emg3d.sim.compute"):
                            with tracing.span("emg3d.sim.grid"):
                                tracing.count("sim_grids")
                            tracing.count("sim_models", 2)
                        tracing.count("sim_models", 2)
                else:
                    with tracing.span("emg3d.sim.compute"):
                        for _ in range(3):
                            with tracing.span("emg3d.sim.grid"):
                                tracing.count("sim_grids")
                                time.sleep(0.001)
                        tracing.count("sim_models", 6)
                    with tracing.span("emg3d.sim.misfit"):
                        pass
        return tracing.spans()

    yield log
    tracing.clear()


@pytest.mark.parametrize("kind, grids, models", [
    ("gradient", 1.0, 4.0), ("forward", 3.0, 6.0)])
def test_readers_read_either_root(logged, kind, grids, models):
    spans = logged(kind)
    got = read_all({"profile": {"answers": 2}})
    assert got["survey.grids_per_step"] == grids
    assert got["survey.models_per_step"] == models
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name == "emg3d.sim.grid")
    assert got["survey.grid_ms_per_step"] == pytest.approx(1e-6 * ns / 2)


def test_readers_read_no_solve_log(logged):
    # Solves without the survey layer's roots, as the other cells log.
    tracing.clear()
    with tracing.recording():
        with tracing.span("emg3d.solve"):
            pass
    assert set(read_all({"profile": {"answers": 1}}).values()) == {None}
