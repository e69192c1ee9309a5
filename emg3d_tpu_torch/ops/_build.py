"""Build the CUDA sources of the port at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build dir>/lib<name>.so
         csrc/<name>.cu

The library lands in ``emg3d_tpu_torch/_build/<hash of the source>/``
(listed in ``.gitignore``), so an edited source is rebuilt and an
unchanged one is reused.  A missing ``nvcc`` or a failed build raises:
nothing falls back.  Builds of different sources may run in parallel
threads (``nvcc`` runs outside the interpreter lock).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load", "BUILD_SECONDS", "PTXAS_INFO"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Seconds each library took to compile in this process (0.0 if reused),
# and the register/spill report of ``-Xptxas -v`` of each build.
BUILD_SECONDS = {}
PTXAS_INFO = {}

_LIBS = {}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of emg3d_tpu_torch cannot be "
            "built.")
    return found


def _compile(name, src, lib_path):
    nvcc = _nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    # Build into a temporary name and rename: concurrent processes never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    PTXAS_INFO[name] = "\n".join(
        line for line in (proc.stdout + proc.stderr).splitlines()
        if "registers" in line or "spill" in line
        or "Compiling entry" in line)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        src = _CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib_path = _BUILD / digest / f"lib{name}.so"
        if lib_path.is_file():
            BUILD_SECONDS.setdefault(name, 0.0)
        else:
            _compile(name, src, lib_path)
        _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]
