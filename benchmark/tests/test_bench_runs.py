"""The command as the check runs it: with no card, and in a checkout that
holds only the benchmark, it prints no result and exits with another code
than 0; the harness and the reference load neither JAX nor the JAX
package; on a card, each cell runs and comes out correct."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
RUN = ["benchmark/run.py", "--seed", "4294967311", "--seconds", "1",
       "--trace", "0"]
CELLS = sorted(p.name[:-5]
               for p in (CHECKOUT / "benchmark" / "workloads").glob("*.json"))
FORBIDDEN = {"jax", "jaxlib", "flax", "emg3d_tpu"}


def _env(tmp_path):
    # No card: the command must fail, not fall back to the CPU.
    return {**os.environ, "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path),
            "TMPDIR": str(tmp_path)}


def _no_result(proc):
    for line in proc.stdout.splitlines():
        try:
            assert not isinstance(json.loads(line), dict), line
        except json.JSONDecodeError:
            pass


def test_no_card_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, *RUN, "--workload", "triaxial_128.solve", "--out",
         str(tmp_path)], cwd=CHECKOUT, env=_env(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    _no_result(proc)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    # A directory with BENCHMARK.json and the benchmark's files only.
    alone = tmp_path / "alone"
    shutil.copytree(CHECKOUT / "benchmark", alone / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", alone)
    proc = subprocess.run(
        [sys.executable, *RUN, "--workload", "triaxial_128.solve"],
        cwd=alone, env=_env(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    _no_result(proc)


@pytest.mark.parametrize("what, forbidden", [
    ("harness", FORBIDDEN),
    ("reference", FORBIDDEN | {"emg3d_tpu_torch"}),
])
def test_imports(what, forbidden, tmp_path):
    # Top-level module names, compared whole: emg3d_tpu_torch is not
    # emg3d_tpu.
    loads = {
        "harness": (
            "import runpy, pathlib\n"
            "from benchmark import harness\n"
            "runpy.run_path('benchmark/run.py', run_name='benchmark_run')\n"
            "runpy.run_path('benchmark/control.py', run_name='control')\n"
            "for sub in ('builders', 'entries', 'metrics'):\n"
            "    for p in sorted(pathlib.Path('benchmark', sub)"
            ".glob('*.py')):\n"
            "        harness.load_module(p.resolve())\n"),
        "reference": "import benchmark.reference.maxwell, "
                     "benchmark.reference.sources\n",
    }[what]
    code = (f"import sys\nsys.path.insert(0, '.')\n{loads}"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                          env=_env(tmp_path), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & forbidden, loaded & forbidden
    if what == "harness":
        assert "emg3d_tpu_torch" in loaded


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, cuda, tmp_path):
    proc = subprocess.run(
        [sys.executable, *RUN, "--workload", cell, "--out", str(tmp_path)],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
