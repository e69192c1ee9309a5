"""The readers of the program's spans and counters
(``benchmark/spanlog.py``): each reads a number from a log that a solve
made under a CPU profiler, and nothing from an empty log, from a log
whose answers differ from the traced span's, or without a traced span."""

import numpy as np
import pytest

from benchmark import harness

READERS = ("model.volume_ms_per_solve", "hierarchy.build_ms_per_solve",
           "fields.copy_ms_per_solve", "copies.h2d_MB_per_solve",
           "copies.d2h_MB_per_solve", "solver.host_syncs_per_solve",
           "kernels.launches_per_solve")


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


@pytest.fixture(scope="module")
def profiled():
    """Two 8^3 solves and one 2-lane batched solve under a CPU profiler:
    4 answers."""
    from torch.profiler import ProfilerActivity, profile

    import emg3d_tpu_torch as t3
    from emg3d_tpu_torch import tracing

    grid = t3.TensorMesh([np.ones(8) * 50.0] * 3, origin=(-200.,) * 3)
    model = t3.Model(grid, property_x=1.0)
    sfield = t3.get_source_field(grid, (0., 0., 0., 0., 0.), 1.0)
    opts = dict(device="cpu", cycle="V", maxit=1, verb=-1)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            t3.solve(model, sfield, plain=True, **opts)
        t3.solve_batch_fields(model, [sfield, sfield], **opts)
    yield tracing
    tracing.clear()


def test_readers_read_the_log(profiled):
    record = {"profile": {"answers": 4}}
    values = {name: reader(name)(record) for name in READERS}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["solver.host_syncs_per_solve"] > 0
    assert values["copies.h2d_MB_per_solve"] > 0
    # A field of 8^3 edges in complex128 comes back for every answer.
    assert values["copies.d2h_MB_per_solve"] >= 3 * 8 * 81 * 16 * 1e-6
    assert values["hierarchy.build_ms_per_solve"] > 0


@pytest.mark.parametrize("record", [{"profile": {"answers": 5}},
                                    {"profile": None}, {}])
def test_readers_read_nothing_else(profiled, record):
    assert all(reader(name)(record) is None for name in READERS)


def test_empty_log_reads_nothing(profiled):
    # Empties the module's log: the last test of the file.
    profiled.clear()
    assert all(reader(name)({"profile": {"answers": 4}}) is None
               for name in READERS)
