"""Multi-device dry run: both parallel strategies on small shapes.

Port of ``dryrun_multichip`` of ``__graft_entry__.py``: the task axis of
the batch engine over a 1-D mesh, and one solve whose grid is sharded
over a 2-D mesh, each held against the same work on one device.  Runs in
complex128 on any device list, e.g. ``['cpu'] * 4`` or ``['cuda:0'] *
4``, as the JAX package's dry run runs in float64 on a virtual CPU mesh.
"""

import numpy as np
import torch

from emg3d_tpu_torch import fields, meshes, models, solver
from emg3d_tpu_torch.parallel import batch, domain

__all__ = ["dryrun_multichip"]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def dryrun_multichip(n_devices, devices=None):
    """Sharded solves on ``n_devices`` mesh entries of ``devices``
    (default: the CUDA cards), each against one device; raises on any
    mismatch.

    1. Task batch: an 8^3 batch of one task per entry over a task mesh,
       one F-cycle; lane 1 equals the single-task batch to 1e-10.
    2. The batched MG-preconditioned BiCGSTAB over the mesh to tol 1e-6:
       every lane ``CONVERGED``.
    3. A batched adjoint step: conjugated fields as right-hand sides,
       warm-started, finite.
    4. A grid-sharded 16^3 solve (plain F-cycles to 1e-6) equal to the
       unsharded one to 1e-10, in the same cycles.

    Returns a dict of the measured differences.
    """
    devs = domain.device_list(n_devices, devices)
    mesh = batch.make_task_mesh(devices=devs)
    opts = dict(dtype=torch.complex128)

    n = 8
    h = np.full(n, 50.0)
    grid = meshes.TensorMesh([h, h, h], origin=(-n * 25.0,) * 3)
    model = models.Model(grid, property_x=1.0)

    # One task per entry: distinct x-dipole sources, two frequencies.
    sources = [(0., 0., 50.0 * (i % 4), 0., 0.) for i in range(n_devices)]
    freqs = [1.0 if i % 2 else 2.0 for i in range(n_devices)]

    # verb=-1 on the maxit=1 legs: they are truncated on purpose.
    efields, info = batch.solve_batch(
        model, sources, freqs, mesh=mesh, maxit=1, cycle='F', verb=-1,
        **opts)
    if len(efields) != n_devices or not np.all(
            np.isfinite(info["abs_error"])):
        raise RuntimeError(f"task batch: {info}")

    # The sharded batch against an unsharded single-task batch of the
    # same (source, frequency).
    lane = min(1, n_devices - 1)
    e_ref, _ = batch.solve_batch(
        model, [sources[lane]], [freqs[lane]], maxit=1, cycle='F',
        verb=-1, device=devs[0], **opts)
    batch_rel = _rel(efields[lane].field, e_ref[0].field)
    if not batch_rel < 1e-10:
        raise RuntimeError(f"sharded batch deviates: {batch_rel}")

    # The production configuration, to convergence over the mesh.
    efields2, info2 = batch.solve_batch(
        model, sources, freqs, mesh=mesh, tol=1e-6, maxit=20,
        sslsolver=True, cycle='V', **opts)
    if info2["exit_messages"] != ["CONVERGED"] * n_devices:
        raise RuntimeError(
            f"sharded production solve did not converge: "
            f"{info2['exit_messages']} (rel_error {info2['rel_error']})")

    # Batched adjoint step: residual-like source fields, warm-started.
    rfields = []
    for i, ef in enumerate(efields):
        rf = fields.Field(grid, frequency=freqs[i])
        rf.field = np.conj(ef.field) * (0.5 + 0.1 * i)
        rfields.append(rf)
    bfields, binfo = batch.solve_batch_fields(
        model, rfields, mesh=mesh, maxit=1, cycle='F', verb=-1,
        efields=[None] * (n_devices - 1) + [efields[-1]], **opts)
    if len(bfields) != n_devices or not np.all(
            np.isfinite(binfo["abs_error"])):
        raise RuntimeError(f"batched adjoint step: {binfo}")

    # Grid-sharded solve against the unsharded one.
    n = 16
    h = np.full(n, 50.0)
    grid = meshes.TensorMesh([h, h, h], origin=(-n * 25.0,) * 3)
    model = models.Model(grid, property_x=1.0)
    sfield = fields.get_source_field(grid, (0., 0., 0., 0., 0.), 1.0)
    kw = dict(plain=True, tol=1e-6, return_info=True, **opts)
    gmesh = domain.make_grid_mesh(devices=devs)
    e_sh, i_sh = solver.solve(model, sfield, mesh=gmesh, **kw)
    e_one, i_one = solver.solve(model, sfield, device=devs[0], **kw)
    grid_rel = _rel(e_sh.field, e_one.field)
    if (i_sh["exit_message"] != "CONVERGED" or i_sh["it_mg"]
            != i_one["it_mg"] or not grid_rel < 1e-10):
        raise RuntimeError(
            f"grid-sharded solve deviates: {grid_rel}, it_mg "
            f"{i_sh['it_mg']} against {i_one['it_mg']}, "
            f"{i_sh['exit_message']}")

    print(f"dryrun_multichip OK on {n_devices} entries "
          f"{[str(d) for d in devs]}: sharded batch parity {batch_rel:.1e}, "
          f"production batch CONVERGED on all {n_devices} lanes, batched "
          f"adjoint finite, grid-sharded 16^3 solve on a "
          f"{gmesh.shape} mesh parity {grid_rel:.1e} in "
          f"{i_sh['it_mg']} cycles.")
    return {"batch_rel": batch_rel, "grid_rel": grid_rel,
            "it_mg": i_sh["it_mg"], "mesh": gmesh.shape}

