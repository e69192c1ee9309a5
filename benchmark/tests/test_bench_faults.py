"""A small copy of each cell, run on the CPU with the timed path broken
underneath, comes out not correct: a step that returns its state
unchanged, an answer altered where it is produced, half of a batch left
out."""

import numpy as np
import pytest
import torch

import emg3d_tpu_torch as e3

from benchmark.tests.small import run


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _solve_then(change):
    solve = e3.solve

    def broken(*args, **kwargs):
        efield, info = solve(*args, **kwargs)
        change(efield)
        return efield, info
    return broken


def _unchanged(efield):
    efield.field = np.zeros_like(efield.field)      # the initial guess


def _altered(efield):
    efield.field = efield.field * (1 + 1e-3)


@pytest.mark.parametrize("change", [_unchanged, _altered])
def test_solve_fault(change, monkeypatch, tmp_path):
    monkeypatch.setattr(e3, "solve", _solve_then(change))
    result, _ = run("triaxial_128.solve", tmp_path)
    assert not result["correct"], result["checks"]


def test_batch_half_left_out(monkeypatch, tmp_path):
    solve = e3.solve_batch_fields

    def half(model, sfields, **kwargs):
        n = len(sfields) // 2
        out, info = solve(model, sfields[:n], **kwargs)
        out += [e3.Field(model.grid, frequency=sf._frequency)
                for sf in sfields[n:]]
        info["exit_messages"] = list(info["exit_messages"]) + [
            "CONVERGED"] * (len(sfields) - n)
        return out, info

    monkeypatch.setattr(e3, "solve_batch_fields", half)
    result, _ = run("triaxial_128.batch8", tmp_path)
    assert not result["correct"], result["checks"]


def test_batch_answer_altered(monkeypatch, tmp_path):
    solve = e3.solve_batch_fields

    def altered(model, sfields, **kwargs):
        out, info = solve(model, sfields, **kwargs)
        _altered(out[-1])
        return out, info

    monkeypatch.setattr(e3, "solve_batch_fields", altered)
    result, _ = run("triaxial_128.batch8", tmp_path)
    assert not result["correct"], result["checks"]

