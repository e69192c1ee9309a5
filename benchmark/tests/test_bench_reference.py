"""The plain reference against the program on the CPU, and the control
against the limits: the reference's operator and sources equal the
program's; a small copy of each cell comes out correct; the control in
the program's place comes out over a limit."""

import numpy as np
import pytest
import torch

import emg3d_tpu_torch as e3
from emg3d_tpu_torch import fields, models, solver

from benchmark.reference import maxwell, sources
from benchmark.tests.small import run

CELLS = ["triaxial_128.solve", "triaxial_128.batch8"]


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_operator_and_sources_equal_the_program():
    rng = np.random.default_rng(3)
    h = [rng.uniform(20, 60, n) for n in (12, 10, 14)]
    origin = (-300.0, -250.0, -350.0)
    rho = [rng.uniform(0.5, 5, (12, 10, 14)) for _ in range(3)]
    grid = e3.TensorMesh(h, origin=origin)
    model = e3.Model(grid, property_x=rho[0], property_y=rho[1],
                     property_z=rho[2], mapping="Resistivity")
    src = (13.0, -27.0, 5.0, 30.0, 20.0)
    sfield = fields.get_source_field(grid, e3.TxElectricPoint(src), 0.7)
    efield = fields.Field(grid, data=rng.standard_normal(grid.n_edges)
                          + 1j * rng.standard_normal(grid.n_edges),
                          frequency=0.7)
    program = solver.residual(models.VolumeModel(model, sfield), sfield,
                              efield, True, device="cpu") / np.linalg.norm(
                                  sfield.field)

    g = maxwell.Grid(h, origin)
    s = sources.point_field(g, src[:3], sources.orientation(*src[3:]), 1.0,
                            0.7)
    for a, b in zip(s, (sfield.fx, sfield.fy, sfield.fz)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * abs(b).max())
    eta, zeta = maxwell.eta_zeta(g, rho, 0.7, "cpu")
    ref = maxwell.rel_residual(
        maxwell.to_device(s, "cpu"),
        maxwell.to_device((efield.fx, efield.fy, efield.fz), "cpu"), eta,
        zeta, tuple(torch.as_tensor(w) for w in g.h))
    assert ref == pytest.approx(program, rel=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_and_control_not(cell, tmp_path):
    result, record = run(cell, tmp_path, control=True)
    checks = result["checks"]
    assert result["correct"], checks
    assert record["checked"] >= 1 and result["attempted"] >= 1
    limits = {k: c["limit"] for k, c in checks.items()}
    # The control fails at least one number.
    assert any(record["control"][k] > limits[k] for k in limits), (
        record["control"], limits)
