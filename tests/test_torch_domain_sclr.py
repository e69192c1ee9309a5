"""PyTorch port, the grid-sharded solve with semicoarsening and line
relaxation against ``emg3d_tpu`` on the CPU.

The ``sclr`` case of tests/test_domain.py (16^3 stretched, anisotropic,
semicoarsening cycling 1-2-3, x-line relaxation, tol 5e-5): the port's
solve sharded over ``['cpu'] * 8`` against the JAX package's unsharded
``solver.solve`` (the same ``it_mg``, fields to 1e-10) and against the
port's unsharded solve (to 1e-12).  The JAX package's solve is read
from tests/data/torch_reference.npz (written by
tests/create_data/torch_reference.py from the JAX package).
"""

from test_torch_domain import _one_thread, check_case  # noqa: F401


def test_sharded_sclr_solve_equals_jax():
    check_case('sclr')
