"""PyTorch port, the grid-sharded solve (``parallel.domain``) on the CPU.

The port's mesh is a list of ``torch.device`` entries driven by one host
loop; ``['cpu'] * 8`` is its counterpart of the 8-device virtual CPU mesh
of tests/test_domain.py, which holds the JAX package's sharded solve
equal to its unsharded one.  Here, in complex128:

- ``make_grid_mesh`` factors 8, 4 and 2 entries as the JAX package does,
  and the level plan equals ``emg3d_tpu.parallel.domain.GridPlacement
  .spec`` (it reads only the mesh shape);
- one sharded smoothing call (the plain point phase, every color; the
  plain line phase along x, y and z) equals the unsharded one bit for
  bit, also on a stretched odd shape;
- the port's sharded solve over ``['cpu'] * 8`` against the JAX
  package's unsharded ``solver.solve`` for the cases of
  tests/test_domain.py (16^3, tol 5e-5; the semicoarsening and line
  relaxation case in tests/test_torch_domain_sclr.py): the same
  ``it_mg``, fields to 1e-10, and against the port's unsharded solve to
  1e-12.  The JAX package's solves are read from
  tests/data/torch_reference.npz (written by
  tests/create_data/torch_reference.py from the JAX package);
- a grid too small to shard runs replicated, on the mesh's first device.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu.parallel import domain as jdomain
from emg3d_tpu_torch import models, solver
from emg3d_tpu_torch.ops import smoothers
from emg3d_tpu_torch.parallel import domain
from torch_reference import Field, reference

SOURCE = (0., 0., 0., 0., 0.)
FREQUENCY = 0.9
CASES = {
    'plain': dict(plain=True),
    'sclr': dict(sslsolver=False, semicoarsening=True, linerelaxation=1),
    'bicgstab': dict(sslsolver='bicgstab', semicoarsening=False,
                     linerelaxation=False),
}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def problem(mod, n=16, stretched=False, anisotropic=False):
    """The problem of tests/test_domain.py, by package ``mod``."""
    if stretched:
        h = [np.full(n, 40.0), np.full(n, 55.0),
             40.0 * 1.06 ** np.arange(n)]
    else:
        h = [np.full(n, 40.0)] * 3
    grid = mod.TensorMesh(h, origin=(-n * 20.0,) * 3)
    if anisotropic:
        rng = np.random.default_rng(11)
        model = mod.Model(
            grid, property_x=rng.uniform(0.5, 2.0, grid.n_cells),
            property_y=rng.uniform(0.5, 2.0, grid.n_cells),
            property_z=rng.uniform(0.5, 2.0, grid.n_cells))
    else:
        model = mod.Model(grid, property_x=1.0)
    sfield = mod.get_source_field(grid, source=SOURCE, frequency=FREQUENCY)
    return model, sfield


def case_setup(case):
    """(``problem`` arguments, solver options) of ``case``."""
    kw = dict(tol=5e-5, maxit=30, verb=0, return_info=True, **CASES[case])
    return dict(stretched=case == 'sclr', anisotropic=case != 'plain'), kw


def case_inputs(case):
    """What the JAX package's solve of ``case`` depends on."""
    args, kw = case_setup(case)
    return problem(t3, **args)[0], SOURCE, FREQUENCY, kw


def solve_case(case):
    """(JAX unsharded, read from tests/data/torch_reference.npz; port
    unsharded; port sharded over ['cpu'] * 8): each (field, info)."""
    args, kw = case_setup(case)
    ref = reference(f'domain.{case}', *case_inputs(case))
    ref = Field(ref['field']), ref
    one = t3.solve(*problem(t3, **args), device='cpu', **kw)
    mesh = domain.make_grid_mesh(devices=['cpu'] * 8)
    sharded = t3.solve(*problem(t3, **args), mesh=mesh, **kw)
    return ref, one, sharded


def check_case(case):
    (e_ref, i_ref), (e_one, i_one), (e_sh, i_sh) = solve_case(case)
    assert i_ref['exit_message'] == 'CONVERGED'
    assert i_sh['exit_message'] == 'CONVERGED'
    assert i_sh['it_mg'] == i_one['it_mg'] == i_ref['it_mg']
    assert i_sh['it_ssl'] == i_one['it_ssl'] == i_ref['it_ssl']
    nrm = np.linalg.norm(e_ref.field)
    assert np.linalg.norm(e_sh.field - e_ref.field) / nrm < 1e-10
    assert (np.linalg.norm(e_sh.field - e_one.field)
            / np.linalg.norm(e_one.field)) < 1e-12


def test_make_grid_mesh_factorization():
    mesh = domain.make_grid_mesh(devices=['cpu'] * 8)
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ('gy', 'gz')
    assert all(d == torch.device('cpu') for d in mesh.devices.flat)
    assert domain.make_grid_mesh(devices=['cpu'] * 4).devices.shape == (2, 2)
    assert domain.make_grid_mesh(devices=['cpu'] * 2).devices.shape == (2, 1)
    assert domain.make_grid_mesh(3, devices=['cpu'] * 8).shape == (3, 1)
    for n in (8, 4, 2):
        assert (domain.make_grid_mesh(devices=['cpu'] * n).shape
                == jdomain.make_grid_mesh(n).devices.shape)


def test_mesh_rejects():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        domain.make_grid_mesh()              # no card here
    with pytest.raises(RuntimeError):
        domain.make_grid_mesh(devices=['nonsense'])
    with pytest.raises(ValueError, match='Unsupported device'):
        domain.make_grid_mesh(devices=['meta'])
    with pytest.raises(ValueError, match='n_devices'):
        domain.make_grid_mesh(5, devices=['cpu'] * 4)
    with pytest.raises(TypeError, match='DeviceGrid'):
        domain.GridPlacement(t3.parallel.make_task_mesh(devices=['cpu']))


@pytest.mark.parametrize('shape', [(32, 32, 32), (8, 8, 8), (16, 40, 18),
                                   (9, 17, 33), (16, 15, 16)])
def test_level_plan_equals_jax(shape):
    """The plan of every level of the default solve's hierarchies equals
    the JAX package's spec on a (4, 2) mesh."""
    jplc = jdomain.GridPlacement(jdomain.make_grid_mesh(8))
    plc = domain.GridPlacement(domain.make_grid_mesh(devices=['cpu'] * 8))
    assert (plc.spec(shape) == 'sharded') == (jplc.spec(shape).spec != ())

    grid = t3.TensorMesh([np.full(n, 50.0) for n in shape], (0., 0., 0.))
    model = t3.Model(grid, property_x=1.0)
    vmodel = models.VolumeModel(model, t3.get_source_field(
        grid, (100., 100., 100., 0., 0.), 1.0))
    var = solver.MGParameters(verb=0, sslsolver=True, semicoarsening=True,
                              linerelaxation=True, shape_cells=shape,
                              device='cpu')
    var.placement = plc
    hier = solver._Hierarchies(vmodel, var)
    for sc in (1, 2, 3):
        meta, levels = hier.get(sc, 4)
        for (lshape, _, _), lvl in zip(meta, levels):
            assert lvl.sharded == (jplc.spec(lshape).spec != ()), lshape
            if lvl.sharded:
                # Seams even; extents start even.
                lay = lvl.layout
                assert all(c % 2 == 0 for ax in (1, 2)
                           for c in lay.cuts(ax)[1:-1])
                assert all(a % 2 == 0 for _, _, ext in lay.blocks
                           for a, _ in ext)


def test_sharded_field_actually_sharded():
    """The level-0 tensors live in 8 blocks; on the (4, 2) mesh 8^3 and
    below are replicated."""
    model, sfield = problem(t3)
    plc = domain.GridPlacement(domain.make_grid_mesh(devices=['cpu'] * 8))
    var = solver.MGParameters(verb=0, sslsolver=False, semicoarsening=False,
                              linerelaxation=False, shape_cells=model.shape,
                              device='cpu')
    var.placement = plc
    meta, levels = solver._Hierarchies(models.VolumeModel(model, sfield),
                                       var).get(0, 0)
    assert levels[0].sharded and len(levels[0].blocks) == 8
    whole = sum(t.numel() * t.element_size() for t in solver._level_tensors(
        *(np.zeros((16, 16, 16)),) * 4, [np.ones(16)] * 3, 'cpu',
        (torch.complex128, torch.float64)))
    # y in 4 blocks of 4 cells, z in 2 of 8, each with up to 2 halo cells
    # on a side: at most 8 x 10 of 16 x 16 cells.
    pieces = levels[0].piece_bytes()
    assert max(pieces) < 0.32 * whole and sum(pieces) > whole
    assert [lvl.sharded for lvl in levels] == [True, False, False, False]
    assert levels[1].ops[0].shape == (8, 8, 8)


def random_fields(shape, seed):
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    shapes = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz)]
    return [rng.standard_normal(s) + 1j * rng.standard_normal(s)
            for s in shapes]


@pytest.mark.parametrize('shape,ndev', [((9, 18, 17), 8), ((8, 16, 16), 4)])
@pytest.mark.parametrize('axis', [None, 0, 1, 2])
def test_sharded_smoothing_bit_for_bit(shape, ndev, axis):
    """One sharded smoothing call (two sweeps: every color forward, then
    backward) equals the unsharded one bit for bit: the point phase
    (``axis`` None) and the line phase along each axis (y- and z-lines
    on the level's line layout)."""
    rng = np.random.default_rng(3)
    h = [40.0 * 1.05 ** np.arange(n) for n in shape]
    grid = t3.TensorMesh(h, origin=(0., 0., 0.))
    model = t3.Model(grid, property_x=rng.uniform(0.5, 2, shape),
                     property_y=rng.uniform(0.5, 2, shape),
                     property_z=rng.uniform(0.5, 2, shape))
    vm = models.VolumeModel(model, t3.get_source_field(
        grid, (100., 300., 300., 0., 0.), 1.0))
    dt = (torch.complex128, torch.float64)
    plc = domain.GridPlacement(domain.make_grid_mesh(devices=['cpu'] * ndev))
    lay = plc.layout(shape)
    assert lay is not None and len(lay.blocks) == ndev
    arrays = (vm.eta_x, vm.eta_y, vm.eta_z, vm.zeta)
    lvl = plc.level(lay, arrays, [np.asarray(x) for x in grid.h], dt)
    ops = solver._level_tensors(*arrays, grid.h, 'cpu', dt)

    e, s = random_fields(shape, 1), random_fields(shape, 2)
    whole = tuple(torch.from_numpy(a.copy()) for a in e)
    src = tuple(torch.from_numpy(a) for a in s)
    pieces = domain.place_field(lay, e, torch.complex128)
    if axis is None:
        smoothers.gauss_seidel(*whole, *src, *ops, 2)
    else:
        smoothers.gauss_seidel_line(*whole, *src, *ops, 2, axis)
    lvl.relax(pieces, domain.place_field(lay, s, torch.complex128), 2, axis)
    for a, b, c in zip(domain.gather_field(pieces, torch.device('cpu')),
                       whole, e):
        assert not torch.equal(b, torch.from_numpy(c))     # it relaxed
        assert torch.equal(a, b)
    # The halos equal their owners' entries.
    for p in pieces:
        parts = [t.clone() for t in p.parts]
        p.exchange()
        assert all(torch.equal(a, b) for a, b in zip(parts, p.parts))


@pytest.mark.parametrize('case', ['plain', 'bicgstab'])
def test_sharded_solve_equals_jax(case):
    check_case(case)


def test_unshardable_level_is_replicated():
    """ny // sy < min_local: the finest level (so every level) is
    replicated, on the mesh's first device, and the solve is the
    unsharded one."""
    grid = t3.TensorMesh([np.full(16, 40.), np.full(6, 40.),
                          np.full(16, 40.)], origin=(-320., -120., -320.))
    model = t3.Model(grid, property_x=1.0)
    sfield = t3.get_source_field(grid, (0., 0., 0., 0., 0.), 0.9)
    plc = domain.GridPlacement(domain.make_grid_mesh(devices=['cpu'] * 4))
    assert plc.spec((16, 6, 16)) == 'replicated'
    assert plc.layout((16, 6, 16)) is None
    kw = dict(plain=True, tol=1e-6, return_info=True)
    e_sh, i_sh = t3.solve(model, sfield, mesh=plc, **kw)
    e_one, i_one = t3.solve(model, sfield, device='cpu', **kw)
    assert i_sh['it_mg'] == i_one['it_mg']
    assert np.array_equal(e_sh.field, e_one.field)
