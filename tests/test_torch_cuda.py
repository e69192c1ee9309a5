"""PyTorch port, the hand-written CUDA kernels on the card.

Imports neither JAX nor emg3d_tpu, so it also runs on a machine with a
CUDA card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py

Elsewhere every test skips (the kernels have no CPU mode).  Each kernel
(``gs_phase``, ``line_phase``) is held against its plain PyTorch version
on the same card, norm-wise per output array on the entries the phase
changed: complex128/float64 to 1e-12 (same arithmetic, another order and
FMA contraction), complex64/float32 to 1e-5 for ``gs_phase`` and to 1e-6
for ``line_phase`` (four times its measured error, so that a lost digit
shows).  A batched launch (a leading task axis) equals single launches
task by task: bit for bit with a stacked or a shared eta, and, with a
per-task eta scale, to 1e-13 (complex128) and 1e-6 (complex64) against
single launches on ``scale[k] * eta`` built by PyTorch.  The survey
layer on the card is held against the CPU path in complex128:
``get_magnetic_field`` to 1e-12, the gradient of a 16^3 ``Simulation``
to 1e-8 of the largest entry, and ``solve_batch`` at 16^3 with the same
iterations and fields to 1e-10.  The multi-device layer on four mesh
entries of ``cuda:0``: a 32^3 grid-sharded solve equals the unsharded one
(plain F-cycles bit for bit, the default solver to 1e-12 in complex128),
and a batch over a task mesh equals the unsharded batch to 1e-12.
"""

import itertools

import numpy as np
import pytest
import torch

from emg3d_tpu_torch.ops import gs_phase, line_phase, smoothers

COLORS = list(itertools.product((0, 1), repeat=3))
DTYPES = [(torch.complex128, torch.float64, 1e-12),
          (torch.complex64, torch.float32, 1e-5),
          (torch.float64, torch.float64, 1e-12),
          (torch.float32, torch.float32, 1e-5)]
LINE_DTYPES = [(torch.complex128, torch.float64, 1e-12),
               (torch.complex64, torch.float32, 1e-6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the CUDA kernels have no CPU mode')
    return torch.device('cuda')


def _operands(shape, dtype, rdt, device, seed=21):
    """Random phase operands (numpy seed) on ``device``."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    shp = [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz),
           (nx, ny, nz)]
    cplx = dtype.is_complex

    def f(s, lo=-1., hi=1., im=(-1., 1.)):
        a = rng.uniform(lo, hi, s)
        if cplx:
            a = a + 1j * rng.uniform(*im, s)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    # eta of the size of the curl-curl terms (~4 zeta / h^2), so that
    # neither dominates the 6x6 systems.
    e = [f(s) for s in shp[:3]]
    s = [f(s) for s in shp[:3]]
    eta = [f(shp[3], -5., -1., (1., 5.)) for _ in range(3)]
    zeta = torch.from_numpy(rng.uniform(1e3, 2e3, shp[3])).to(device, rdt)
    h = [torch.from_numpy(rng.uniform(20, 60, n)).to(device, rdt)
         for n in shape]
    return [*e, *s, *eta, zeta, *h]


def _rel_err(out, ref, base):
    """Worst ||a - b|| / ||b|| over ex/ey/ez, on the entries the plain
    version changed."""
    err = 0.0
    for a, b, c in zip(out[:3], ref[:3], base[:3]):
        mask = b != c
        if mask.any():
            err = max(err, float(torch.linalg.vector_norm(a[mask] - b[mask])
                                 / torch.linalg.vector_norm(b[mask])))
    return err


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rdt,tol', DTYPES)
@pytest.mark.parametrize('shape', [(11, 10, 9), (2, 2, 2), (4, 3, 2)])
def test_kernel_equals_plain(cuda, dtype, rdt, tol, shape):
    base = _operands(shape, dtype, rdt, cuda)
    for color in smoothers.phase_colors(shape, False):
        ref = [t.clone() for t in base]
        out = [t.clone() for t in base]
        smoothers._gauss_seidel_phase_torch(*ref, *color)
        launches = gs_phase.LAUNCHES
        smoothers.gauss_seidel_phase(*out, *color)
        torch.cuda.synchronize()
        assert gs_phase.LAUNCHES == launches + 1
        assert any(not torch.equal(b, c) for b, c in zip(ref, base))
        err = _rel_err(out, ref, base)
        assert err <= tol, (color, err)


@pytest.mark.cuda
def test_empty_phase_launches_nothing(cuda):
    args = _operands((2, 2, 2), torch.complex64, torch.float32, cuda)
    launches = gs_phase.LAUNCHES
    before = [t.clone() for t in args[:3]]
    gs_phase.gauss_seidel_phase_cuda(*args, 1, 0, 0)
    assert gs_phase.LAUNCHES == launches
    for a, b in zip(args[:3], before):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(cuda):
    args = _operands((5, 4, 3), torch.complex64, torch.float32, cuda)
    bad_dtype = list(args)
    bad_dtype[3] = bad_dtype[3].to(torch.complex128)
    bad_shape = list(args)
    bad_shape[6] = bad_shape[6][:, :, :2]
    non_contig = list(args)
    non_contig[9] = non_contig[9].transpose(0, 1).contiguous().transpose(0, 1)
    cpu = list(args)
    cpu[4] = cpu[4].cpu()
    for bad, exc in ((bad_dtype, TypeError), (bad_shape, ValueError),
                     (non_contig, ValueError), (cpu, ValueError)):
        with pytest.raises(exc):
            gs_phase.gauss_seidel_phase_cuda(*bad, 0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rdt,tol', LINE_DTYPES)
@pytest.mark.parametrize('shape', [(9, 6, 7), (2, 5, 4), (16, 3, 2),
                                   (128, 4, 2), (2, 64, 2)])
@pytest.mark.parametrize('axis', [0, 1, 2])
def test_line_kernel_equals_plain(cuda, dtype, rdt, tol, shape, axis):
    base = _operands(shape, dtype, rdt, cuda)
    for color in smoothers.line_phase_colors(shape, axis, False):
        ref = [t.clone() for t in base]
        out = [t.clone() for t in base]
        smoothers._line_relax_phase_torch(*ref, *color, axis)
        launches = line_phase.LAUNCHES
        smoothers.gauss_seidel_line_phase(*out, *color, axis)
        torch.cuda.synchronize()
        assert line_phase.LAUNCHES == launches + 1
        assert any(not torch.equal(b, c) for b, c in zip(ref, base))
        err = _rel_err(out, ref, base)
        assert err <= tol, (color, err)
        # Entries the phase leaves alone stay bit-identical.
        for a, b, c in zip(out[:3], ref[:3], base[:3]):
            keep = b == c
            assert torch.equal(a[keep], c[keep])


@pytest.mark.cuda
def test_line_wrapper_rejects_bad_input(cuda):
    args = _operands((5, 4, 3), torch.complex64, torch.float32, cuda)
    bad_dtype = list(args)
    bad_dtype[4] = bad_dtype[4].to(torch.complex128)
    bad_shape = list(args)
    bad_shape[7] = bad_shape[7][:, :, :2]
    non_contig = list(args)
    non_contig[0] = non_contig[0].transpose(0, 2).contiguous().transpose(0, 2)
    cpu = list(args)
    cpu[9] = cpu[9].cpu()
    launches = line_phase.LAUNCHES
    for bad, exc in ((bad_dtype, TypeError), (bad_shape, ValueError),
                     (non_contig, ValueError), (cpu, ValueError)):
        with pytest.raises(exc):
            line_phase.gauss_seidel_line_phase_cuda(*bad, 0, 0, 1)
    with pytest.raises(ValueError, match='axis'):
        line_phase.gauss_seidel_line_phase_cuda(*args, 0, 0, 3)
    assert line_phase.LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('shape', [(9, 6, 7), (2, 5, 4)])
def test_line_smoothing_through_one_plan(cuda, shape, axis):
    """gauss_seidel_line (one plan for nu x 4 phases) equals the same
    phases as single calls, bit for bit, and counts the same launches."""
    nu = 3
    base = _operands(shape, torch.complex64, torch.float32, cuda)
    one = [t.clone() for t in base]
    before = line_phase.LAUNCHES
    smoothers.gauss_seidel_line(*one, nu, axis)
    launched = line_phase.LAUNCHES - before
    each = [t.clone() for t in base]
    before = line_phase.LAUNCHES
    for sweep in range(nu):
        for color in smoothers.line_phase_colors(shape, axis, sweep % 2 == 1):
            smoothers.gauss_seidel_line_phase(*each, *color, axis)
    torch.cuda.synchronize()
    assert launched == line_phase.LAUNCHES - before > 0
    for a, b in zip(one[:3], each[:3]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_line_plans_do_not_share_scratch(cuda):
    args = _operands((9, 6, 7), torch.complex64, torch.float32, cuda)
    more = [t.clone() for t in args]
    ref = [t.clone() for t in args]
    plan_a = line_phase.LinePlan(*args, 0)
    plan_b = line_phase.LinePlan(*more, 0)
    assert plan_a._scratch.data_ptr() != plan_b._scratch.data_ptr()
    # Sized for the parity with most lines, allocated once per plan.
    assert plan_a._scratch.numel() == 8 * line_phase.SCRATCH_VALUES * 3 * 3
    # Interleaved launches of the two plans give what each gives alone.
    for color in smoothers.line_phase_colors((9, 6, 7), 0, False):
        plan_a.launch(*color)
        plan_b.launch(*color)
        smoothers.gauss_seidel_line_phase(*ref, *color, 0)
    torch.cuda.synchronize()
    for a, b, c in zip(args[:3], more[:3], ref[:3]):
        assert torch.equal(a, c) and torch.equal(b, c)
    with pytest.raises(ValueError, match='parit'):
        plan_a.launch(2, 0)


def _survey(n, seed=16):
    """A stretched triaxial n^3 survey centred on its two sources."""
    import emg3d_tpu_torch as t3

    rng = np.random.default_rng(seed)
    h = [rng.uniform(60.0, 140.0, n) for _ in range(3)]
    grid = t3.TensorMesh(h, origin=tuple(-0.5 * x.sum() for x in h))
    shape = grid.shape_cells
    model = t3.Model(grid, property_x=rng.uniform(1, 3, shape),
                     property_y=rng.uniform(1, 4, shape),
                     property_z=rng.uniform(2, 6, shape),
                     mapping='Resistivity')
    w = 100.0 * n / 16
    survey = t3.Survey(
        sources=[t3.TxElectricDipole((x, 0., 0., 20., 10.))
                 for x in (-w, w)],
        receivers=[t3.RxElectricPoint((3 * w, w, 0., 0., 0.)),
                   t3.RxMagneticPoint((2 * w, -w, w, 90., 0.))],
        frequencies=[1.0], relative_error=0.05, noise_floor=1e-17)
    return survey, model


@pytest.mark.cuda
def test_magnetic_field_card_equals_cpu(cuda):
    import emg3d_tpu_torch as t3

    _, model = _survey(12)
    rng = np.random.default_rng(3)
    n = model.grid.n_edges
    efield = t3.Field(model.grid, frequency=1.0, data=(
        rng.normal(size=n) + 1j * rng.normal(size=n)))
    on_card = t3.get_magnetic_field(model, efield)
    on_cpu = t3.get_magnetic_field(model, efield, device='cpu')
    assert on_card.field.dtype == np.complex128
    scale = np.abs(on_cpu.field).max()
    assert scale > 0
    assert np.abs(on_card.field - on_cpu.field).max() <= 1e-12 * scale


@pytest.mark.cuda
def test_simulation_gradient_card_equals_cpu(cuda):
    import emg3d_tpu_torch as t3

    grads = []
    for device in (None, 'cpu'):
        survey, model = _survey(16)
        sim = t3.Simulation(
            survey, model, gridding='same', tqdm_opts=False,
            receiver_interpolation='linear', device=device,
            solver_opts={'plain': True, 'tol': 1e-7, 'verb': 0,
                         'dtype': torch.complex128})
        sim.compute(observed=True, add_noise=False)
        sim.data['observed'] = sim.data.observed * 1.1
        grads.append((sim.gradient, sim.misfit, sim.device))
    (g_card, m_card, d_card), (g_cpu, m_cpu, d_cpu) = grads
    assert (d_card, d_cpu) == ('cuda', 'cpu')
    assert g_card.shape == (3, 16, 16, 16) and np.abs(g_cpu).max() > 0
    assert abs(m_card - m_cpu) <= 1e-8 * m_cpu
    assert np.abs(g_card - g_cpu).max() <= 1e-8 * np.abs(g_cpu).max()


# ---------------------------------------------------------------------------
# The task index of both kernels (the batch engine): one launch relaxes one
# color of every task.  Fields (B, ...); eta stacked (B, nx, ny, nz), or
# shared with an optional per-task scale.
# ---------------------------------------------------------------------------

NTASK = 3
# Norm-wise on the changed entries, against single launches on
# scale[k] * eta built by PyTorch: the kernel scales on load, so the two
# differ by the rounding of that product.
SCALED_TOL = {torch.complex128: 1e-13, torch.complex64: 1e-6}


def _batched_operands(shape, dtype, rdt, device, seed=5):
    """(fields, sources, stacked eta, shared eta, zeta and widths, scales)
    for NTASK tasks, from a numpy seed."""
    tasks = [_operands(shape, dtype, rdt, device, seed=seed + k)
             for k in range(NTASK)]
    stack = [torch.stack([t[i] for t in tasks]) for i in range(9)]
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 2.0, NTASK)
    if dtype.is_complex:
        scale = scale + 1j * rng.uniform(-1.0, 1.0, NTASK)
    scale = torch.from_numpy(scale).to(device, dtype)
    return (stack[:3], stack[3:6], stack[6:9], tasks[0][6:9],
            tasks[0][9:], scale)


def _single_launches(launch, e, s, eta_of, rest, args):
    """The phase launched task by task on clones of the fields; task k
    with eta ``eta_of(k)``."""
    out = [c.clone() for c in e]
    for k in range(NTASK):
        launch(*(c[k] for c in out), *(c[k] for c in s), *eta_of(k),
               *rest, *args)
    return out


def _batched_cases(shape, dtype, rdt, cuda):
    """(name, eta, scale, eta of task k, bit for bit?) per layout."""
    e, s, stacked, shared, rest, scale = _batched_operands(
        shape, dtype, rdt, cuda)
    ones = torch.ones_like(scale)
    return e, s, rest, [
        ("stacked", stacked, None, lambda k: [c[k] for c in stacked], True),
        ("shared", shared, None, lambda k: shared, True),
        ("scale 1", shared, ones, lambda k: shared, True),
        ("scale", shared, scale, lambda k: [scale[k] * c for c in shared],
         False)]


def _check_batched(batched, single, plain, e, s, rest, cases, args, tol):
    for name, eta, scale, eta_of, exact in cases:
        out = [c.clone() for c in e]
        batched(*out, *s, *eta, *rest, *args, scale=scale)
        ref = _single_launches(single, e, s, eta_of, rest, args)
        torch.cuda.synchronize()
        if exact:
            for a, b in zip(out, ref):
                assert torch.equal(a, b), name
        else:
            err = _rel_err(out, ref, e)
            assert err <= SCALED_TOL[e[0].dtype], (name, err)
        # The plain version, task by task, to the kernel's tolerance.
        pl = [c.clone() for c in e]
        plain(*pl, *s, *eta, *rest, *args, scale=scale)
        assert _rel_err(out, pl, e) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rdt,tol', DTYPES[:2])
@pytest.mark.parametrize('shape', [(11, 10, 9), (4, 3, 2)])
def test_gs_batched_equals_single_launches(cuda, dtype, rdt, tol, shape):
    e, s, rest, cases = _batched_cases(shape, dtype, rdt, cuda)
    launches = gs_phase.LAUNCHES
    for color in smoothers.phase_colors(shape, False):
        _check_batched(gs_phase.gauss_seidel_phase_cuda,
                       gs_phase.gauss_seidel_phase_cuda,
                       smoothers._gauss_seidel_phase_torch, e, s, rest,
                       cases, color, tol)
    # One launch per batched phase, NTASK per layout for the references.
    ncolors = len(smoothers.phase_colors(shape, False))
    assert gs_phase.LAUNCHES - launches == ncolors * 4 * (1 + NTASK)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rdt,tol', LINE_DTYPES)
@pytest.mark.parametrize('shape', [(9, 6, 7), (2, 5, 4), (16, 3, 2)])
@pytest.mark.parametrize('axis', [0, 1, 2])
def test_line_batched_equals_single_launches(cuda, dtype, rdt, tol, shape,
                                             axis):
    e, s, rest, cases = _batched_cases(shape, dtype, rdt, cuda)
    for color in smoothers.line_phase_colors(shape, axis, False):
        _check_batched(line_phase.gauss_seidel_line_phase_cuda,
                       line_phase.gauss_seidel_line_phase_cuda,
                       smoothers._line_relax_phase_torch, e, s, rest,
                       cases, (*color, axis), tol)


@pytest.mark.cuda
def test_one_task_is_the_unbatched_kernel(cuda):
    """A task axis of 1, no scale, equals the 3-D launch bit for bit."""
    base = _operands((9, 6, 7), torch.complex64, torch.float32, cuda)
    for launch, args in (
            (gs_phase.gauss_seidel_phase_cuda, (1, 0, 1)),
            (line_phase.gauss_seidel_line_phase_cuda, (1, 0, 2))):
        flat = [t.clone() for t in base]
        one = [t.clone()[None] for t in base[:6]]
        launch(*flat, *args)
        launch(*one, *base[6:], *args)
        torch.cuda.synchronize()
        for a, b in zip(one[:3], flat[:3]):
            assert torch.equal(a[0], b)


@pytest.mark.cuda
def test_batched_wrappers_reject_bad_layouts(cuda):
    e, s, stacked, shared, rest, scale = _batched_operands(
        (5, 4, 3), torch.complex64, torch.float32, cuda)
    for plan, extra in ((gs_phase.GsPlan, ()), (line_phase.LinePlan, (0,))):
        with pytest.raises(ValueError, match='shared eta'):
            plan(*e, *s, *stacked, *rest, *extra, scale=scale)
        with pytest.raises(ValueError, match='shape'):
            plan(*e, *s, *shared, *rest, *extra, scale=scale[:2])
        with pytest.raises(TypeError, match='dtype'):
            plan(*e, *s, *shared, *rest, *extra,
                 scale=scale.to(torch.complex128))
        with pytest.raises(ValueError, match='shape'):
            plan(*e, *s, *[c[:2] for c in stacked], *rest, *extra)


@pytest.mark.cuda
def test_solve_batch_card_equals_cpu(cuda):
    """The production configuration over 3 frequencies, complex128: the
    card equals the CPU, iterations and fields to 1e-10."""
    import emg3d_tpu_torch as t3

    _, model = _survey(16)
    sources = [(0., 0., 0., 20., 10.)] * 3
    freqs = [0.5, 1.0, 2.0]
    opts = dict(sslsolver=True, semicoarsening=True, linerelaxation=True,
                tol=1e-6, dtype=torch.complex128)
    launches = line_phase.LAUNCHES
    card, i_card = t3.solve_batch(model, sources, freqs, **opts)
    assert line_phase.LAUNCHES > launches
    cpu, i_cpu = t3.solve_batch(model, sources, freqs, device='cpu', **opts)
    assert (i_card['it_mg'], i_card['it_ssl']) == (i_cpu['it_mg'],
                                                   i_cpu['it_ssl'])
    assert i_card['exit_messages'] == ['CONVERGED'] * 3
    for a, b in zip(card, cpu):
        assert (np.linalg.norm(a.field - b.field)
                <= 1e-10 * np.linalg.norm(b.field))


# --------------------------------------------------------------------------
# The whole-cycle step: every cycle as a replay of a captured CUDA graph.
# --------------------------------------------------------------------------

def _counts():
    return (gs_phase.LAUNCHES, gs_phase.PLAIN_CALLS_ON_CUDA,
            line_phase.LAUNCHES, line_phase.PLAIN_CALLS_ON_CUDA)


def _run_on_card(prof):
    """(gs_phase, line_phase) kernels a ``torch.profiler`` trace saw run
    on the card, launched one by one or replayed in a CUDA graph."""
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return tuple(sum(symbol in n for n in names)
                 for symbol in ('gs_phase_kernel', 'line_phase_kernel'))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['baseline', 'triaxial'])
def test_graph_equals_per_operation(cuda, case, monkeypatch):
    """32^3, plain F-cycles and the default solver: the graph solves equal
    the per-operation solve bit for bit, with the same iterations; the
    second graph solve captures nothing and launches nothing through the
    wrappers; the kernels each graph solve runs on the card (profiler:
    eager first uses and replays, a capture runs nothing) equal the
    per-operation solve's launches."""
    from torch.profiler import ProfilerActivity, profile

    from emg3d_tpu_torch import northstar, solve, solver

    make = getattr(northstar, f'{case}_problem')
    runs = []
    for mode in ('0', 'auto', 'auto'):
        monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', mode)
        gs_phase.reset_counts()
        line_phase.reset_counts()
        solver.reset_counts()
        problem = make(32)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            efield, info = solve(*problem, tol=1e-6, return_info=True,
                                 **northstar.SOLVE_OPTIONS[case])
            torch.cuda.synchronize()
        runs.append((efield.field, info, _counts(), _run_on_card(prof),
                     solver.CYCLE_CAPTURES, solver.CYCLE_REPLAYS))
    (ref, rinfo, rcounts, rcard, rcap, rrep) = runs[0]
    assert rinfo['exit'] == 0 and rcap == rrep == 0
    assert rcard == rcounts[::2] and sum(rcard) > 0
    for field, info, counts, card, _, replays in runs[1:]:
        for key in ('it_ssl', 'it_mg', 'exit_message'):
            assert info[key] == rinfo[key], key
        assert np.array_equal(field, ref)
        assert counts[1] == counts[3] == 0
        assert card == rcounts[::2]
        assert replays > 0
    assert runs[1][4] > 0 and runs[2][4] == 0
    assert runs[2][2] == (0, 0, 0, 0)


@pytest.mark.cuda
def test_launch_counts_are_what_ran(cuda, monkeypatch):
    """32^3, the default solver: a solve's root span counts as launches
    (``tracing.counts()``, wrapper launches plus replayed less captured)
    the kernels the profiler saw run on the card, per operation, in the
    solve that captures and in the one that replays."""
    from torch.profiler import ProfilerActivity, profile

    from emg3d_tpu_torch import northstar, solve, solver, tracing

    solver._STEPS.clear()
    for mode in ('0', 'auto', 'auto'):
        monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', mode)
        problem = northstar.triaxial_problem(32)
        tracing.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve(*problem, tol=1e-6, **northstar.SOLVE_OPTIONS['triaxial'])
            torch.cuda.synchronize()
        (root,) = tracing.roots()
        counts = root.attrs['counts']
        ran = _run_on_card(prof)
        assert (counts['launches.gs_phase'],
                counts['launches.line_phase']) == ran
        assert counts['kernel_launches'] == sum(ran) > 0
        assert (counts['replayed_launches'] > 0) == (mode == 'auto')


def _fresh_process(code):
    """Run ``code`` in a new interpreter from the repo root; its stdout."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.cuda
def test_graph_solve_in_a_fresh_process(cuda):
    """A process whose first kernel launches are its first solve captures
    and converges (the kernels load lazily before their capture)."""
    out = _fresh_process(
        "from emg3d_tpu_torch import northstar, solve, solver\n"
        "ef, info = solve(*northstar.triaxial_problem(32), tol=1e-6,\n"
        "                 return_info=True)\n"
        "print(info['exit_message'], solver.CYCLE_CAPTURES,\n"
        "      solver.CYCLE_REPLAYS)\n")
    message, captures, replays = out.split()[-3:]
    assert message == 'CONVERGED'
    assert int(captures) > 0 and int(replays) > 0


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A host sync inside the cycle makes its capture raise, and nothing
    falls back to the per-operation cycle (in a process of its own)."""
    out = _fresh_process(
        "import torch\n"
        "from emg3d_tpu_torch import northstar, solve, solver\n"
        "accumulate = solver._accumulate_\n"
        "def synced(e_hi, e_lo, de):\n"
        "    float(torch.linalg.vector_norm(de[0]))\n"
        "    return accumulate(e_hi, e_lo, de)\n"
        "solver._accumulate_ = synced\n"
        "try:\n"
        "    solve(*northstar.baseline_problem(32), plain=True, tol=1e-6)\n"
        "except RuntimeError as err:\n"
        "    print('raised', solver.CYCLE_CAPTURES, solver.CYCLE_REPLAYS)\n"
        "else:\n"
        "    print('solved')\n")
    assert out.split()[-3:] == ['raised', '0', '0']


@pytest.mark.cuda
def test_cli_card_equals_cpu(cuda, tmp_path):
    """``python -m emg3d_tpu_torch -g`` with ``device = cuda`` against the
    same run with ``device = cpu``: a 16^3 triaxial simulation with
    observed data, stored with ``dtype`` complex128 and resumed with
    ``--load``, so that the config's device places it.  Data, misfit and
    gradient to 1e-10 of the largest entry."""
    import pathlib
    import subprocess
    import sys

    import emg3d_tpu_torch as t3

    h = np.ones(16) * 100.0
    grid = t3.TensorMesh([h, h, h], origin=(-800.,) * 3)
    model = t3.Model(grid, property_x=1.0, property_y=2.0, property_z=3.0)
    rng = np.random.default_rng(16)
    survey = t3.Survey(
        [t3.TxElectricDipole((0., 0., 0., 0., 0.))],
        [t3.RxElectricPoint((x, 50., 0., 0., 0.)) for x in (250., 350.)],
        [1.0], relative_error=0.05,
        data=1e-8 * (rng.uniform(0.5, 1.5, (1, 2, 1))
                     + 1j * rng.uniform(-0.3, 0.3, (1, 2, 1))))
    sim = t3.Simulation(survey, model, gridding='same',
                        receiver_interpolation='linear', device='cpu',
                        solver_opts={'tol': 1e-6, 'dtype': 'complex128'})
    sim.to_file(str(tmp_path / 'sim.npz'), verb=0)

    root = pathlib.Path(__file__).resolve().parent.parent
    outs = {}
    for device in ('cuda', 'cpu'):
        cfg = tmp_path / f'{device}.cfg'
        cfg.write_text(f"[simulation]\ndevice = {device}\n")
        proc = subprocess.run(
            [sys.executable, '-m', 'emg3d_tpu_torch', str(cfg), '-g',
             '--path', str(tmp_path), '--load', 'sim.npz', '--save',
             f'after_{device}.npz', '--output', f'out_{device}.npz'],
            cwd=root, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        after = t3.load(str(tmp_path / f'after_{device}.npz'))['simulation']
        assert after.device == device
        assert after.solver_opts['dtype'] == 'complex128'
        outs[device] = t3.load(str(tmp_path / f'out_{device}.npz'))
    for key in ('data', 'misfit', 'gradient'):
        a, b = (np.asarray(outs[d][key]) for d in ('cuda', 'cpu'))
        assert np.all(np.isfinite(a)) and np.abs(b).max() > 0, key
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), key


# --------------------------------------------------------------------------
# The multi-device layer on one card: four mesh entries on cuda:0.
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('opts', [dict(plain=True, cycle='F'), {}])
def test_grid_sharded_solve_on_card(cuda, opts, monkeypatch):
    """A 32^3 solve over a 2 x 2 grid mesh of ``cuda:0`` entries equals
    the unsharded per-operation solve: plain F-cycles bit for bit, the
    default solver in the same iterations to 1e-12 (complex128); both
    kernels run on the pieces, no plain version on CUDA."""
    import emg3d_tpu_torch as t3
    from emg3d_tpu_torch.parallel import domain

    _, model = _survey(32)
    sfield = t3.get_source_field(model.grid, (0., 0., 0., 20., 10.), 1.0)
    kw = dict(tol=1e-6, return_info=True, dtype=torch.complex128, **opts)
    monkeypatch.setenv('EMG3D_TPU_CYCLE_JIT', '0')
    one, i_one = t3.solve(model, sfield, **kw)
    before = _counts()
    mesh = domain.make_grid_mesh(devices=['cuda:0'] * 4)
    sh, i_sh = t3.solve(model, sfield, mesh=mesh, **kw)
    after = _counts()
    assert after[0] > before[0] and after[1] == before[1] == 0
    assert after[3] == before[3] == 0
    if not opts:
        assert after[2] > before[2]
    assert (i_sh['it_mg'], i_sh['it_ssl'], i_sh['exit_message']) == (
        i_one['it_mg'], i_one['it_ssl'], 'CONVERGED')
    assert (np.linalg.norm(sh.field - one.field)
            <= 1e-12 * np.linalg.norm(one.field))
    if opts:
        assert np.array_equal(sh.field, one.field)


@pytest.mark.cuda
def test_task_mesh_on_card(cuda):
    """The production batch of 4 frequencies over 3 ``cuda:0`` entries
    (padded to 6 lanes) equals the unsharded batch: the same iterations,
    lanes to 1e-12; no plain version on CUDA."""
    import emg3d_tpu_torch as t3
    from emg3d_tpu_torch.parallel import make_task_mesh

    _, model = _survey(32)
    sources = [(0., 0., 0., 20., 10.)] * 4
    freqs = [0.25, 0.5, 1.0, 2.0]
    opts = dict(sslsolver=True, semicoarsening=True, linerelaxation=True,
                tol=1e-6)
    one, i_one = t3.solve_batch(model, sources, freqs, **opts)
    before = _counts()
    mesh = make_task_mesh(devices=['cuda:0'] * 3)
    sh, i_sh = t3.solve_batch(model, sources, freqs, mesh=mesh, **opts)
    after = _counts()
    assert after[0] > before[0] and after[2] > before[2]
    assert after[1] == after[3] == 0
    assert (i_sh['it_mg'], i_sh['it_ssl']) == (i_one['it_mg'],
                                               i_one['it_ssl'])
    assert i_sh['exit_messages'] == ['CONVERGED'] * 4
    for a, b in zip(sh, one):
        assert (np.linalg.norm(a.field - b.field)
                <= 1e-12 * np.linalg.norm(b.field))
