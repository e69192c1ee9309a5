"""Generate the JAX package's answers to the port's parity tests.

Each case below builds the inputs of one parity test of the port
(``tests/test_torch_*.py``) with the test module's own input functions
and the same seeds, runs the JAX package on them, and keeps what the
test's assertions read, beside a SHA-256 digest of the inputs
(``tests/torch_reference.py``).  The tests read the answers from the file
instead of running the JAX package, whose compiles on XLA:CPU took most
of their time.  Run from the repo root:

    python tests/create_data/torch_reference.py            # every case
    python tests/create_data/torch_reference.py CASE ...   # these, merged

Writes tests/data/torch_reference.npz.  The JAX package is the reference
and is not edited, so its answers are constants: regenerate a case ONLY
when its inputs change (its test then fails naming the case).  Every
group of cases runs in a process of its own, ``JOBS`` at once: XLA:CPU
executables hold memory mappings, and one process for everything would
run out of them.  Same XLA environment as
tests/conftest.py (x64, 8 host devices, no persistent compilation
cache); one torch and one BLAS thread, as in the tests.
"""

import concurrent.futures
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import types
import zipfile
from unittest import mock

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("EMG3D_TPU_SMOOTH_DISPATCH", "phase")

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
# No persistent compilation cache: jax 0.9/XLA:CPU executable
# (de)serialization segfaults intermittently (see tests/conftest.py).

import numpy as np  # noqa: E402
import threadpoolctl  # noqa: E402
import torch  # noqa: E402

TESTS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import emg3d_tpu as e3  # noqa: E402
import emg3d_tpu_torch as t3  # noqa: E402
import torch_reference  # noqa: E402

CASES = {}
JOBS = 4


def case(name, group):
    """Register ``fn() -> (inputs, values)`` as case ``name``; the cases of
    one group run in one process."""
    def register(fn):
        CASES[name] = types.SimpleNamespace(fn=fn, group=group)
        return fn
    return register


def lanes(out):
    """A batch's (fields, info) as stored values."""
    fields, info = out
    return {'fields': np.stack([f.field for f in fields]),
            'it_mg': info['it_mg'], 'it_ssl': info['it_ssl'],
            'exit_messages': np.asarray(info['exit_messages'], dtype=str),
            'rel_error': np.asarray(info['rel_error'])}


# What the tests read of a solve's info (the rest holds its timings too).
INFO = ('exit', 'exit_message', 'it_mg', 'it_ssl', 'rel_error')


def solved(out):
    """A solve's (field, info) as stored values."""
    efield, info = out
    return {'field': np.asarray(efield.field),
            **{key: info[key] for key in INFO}}


# ---------------------------------------------------------------------------
# The batch engine: tests/test_torch_batch*.py, tests/test_torch_task_mesh.py
# ---------------------------------------------------------------------------

def _batch(name, group, kw, epsilon_r=False, warm=False, zero=(),
           shrink=False):
    """A case of ``test_torch_batch.jax_solve``; ``shrink`` sets
    EMG3D_TPU_BATCH_SHRINK=1 and keeps the lines the run printed about
    it."""
    @case(name, group)
    def run():
        import test_torch_batch as tb
        from emg3d_tpu.parallel import batch as jbatch
        model, sfields = tb.problem(e3, epsilon_r, zero)
        efields = None
        if warm:
            efields = jbatch.solve_batch_fields(model, sfields, **kw)[0]
        stdout = io.StringIO()
        shrinks = {'EMG3D_TPU_BATCH_SHRINK': '1' if shrink else '0'}
        with mock.patch.dict(os.environ, shrinks), \
                contextlib.redirect_stdout(stdout):
            out = jbatch.solve_batch_fields(model, sfields, efields=efields,
                                            **kw)
        values = lanes(out)
        if shrink:
            values['stdout'] = '\n'.join(
                line for line in stdout.getvalue().splitlines()
                if 'shrunk' in line)
        return tb.batch_inputs(kw, epsilon_r, warm, zero), values


def _batch_cases():
    import test_torch_batch as tb
    import test_torch_batch_krylov as tk
    plain = tb.CASES['plain']
    _batch('batch.plain', 'batch', plain)
    _batch('batch.plain.warm', 'batch', plain, warm=True)
    _batch('batch.krylov', 'batch_krylov', tk.KRYLOV)
    _batch('batch.stacked', 'batch_layouts', plain, epsilon_r=True)
    _batch('batch.shrink', 'batch_layouts', dict(plain, verb=4),
           zero=(1, 2), shrink=True)


_batch_cases()


def _task_mesh(name):
    @case(f'task_mesh.{name}', 'task_mesh')
    def run():
        import test_torch_task_mesh as tm
        from emg3d_tpu.parallel import batch as jbatch
        out = jbatch.solve_batch_fields(*tm.problem(e3), mesh=None,
                                        **tm.CASES[name])
        return tm.batch_inputs(name), lanes(out)


for _name in ('plain', 'bicgstab'):
    _task_mesh(_name)


# ---------------------------------------------------------------------------
# The grid-sharded solve: tests/test_torch_domain*.py
# ---------------------------------------------------------------------------

def _domain(name):
    @case(f'domain.{name}', 'domain_sclr' if name == 'sclr' else 'domain')
    def run():
        import test_torch_domain as td
        args, kw = td.case_setup(name)
        out = e3.solve(*td.problem(e3, **args), **kw)
        return td.case_inputs(name), solved(out)


for _name in ('plain', 'bicgstab', 'sclr'):
    _domain(_name)


# ---------------------------------------------------------------------------
# Solves: tests/test_torch_solver.py
# ---------------------------------------------------------------------------

def _solver(name, start=None, zero=False, **kw):
    """A case of ``test_torch_solver._both``: ``start`` 'random' is the
    test's warm start, 'solved' the JAX answer of case 'solver.warm';
    ``zero``, a zero source field."""
    @case(f'solver.{name}', 'solver')
    def run():
        import test_torch_solver as ts
        model, sfield = ts.make_problem()
        if zero:
            sfield = e3.Field(sfield.grid, frequency=0.77)
        efield = ts.warm_start(sfield) if start else None
        if start == 'solved':
            efield = e3.solve(model, sfield, **ts.both_options(
                efield, cycle='F', tol=1e-6, always_return=True)[0])[0]
        inputs = (model, sfield, ts.both_options(efield, **kw)[0])
        # A fresh copy of the start: the solve may change it in place.
        jkw = ts.both_options(efield, **kw)[0]
        return inputs, solved(e3.solve(model, sfield, **jkw))


for _name in ('F', 'V', 'W'):
    _solver(_name, cycle=_name, tol=1e-6)
_solver('warm', 'random', cycle='F', tol=1e-6, always_return=True)
_solver('warm.done', 'solved', cycle='F', tol=1e-3, always_return=True)
_solver('zero', zero=True)


# ---------------------------------------------------------------------------
# Field-level wrappers: tests/test_torch_krylov.py
# ---------------------------------------------------------------------------

def _smoothing(lr_dir):
    @case(f'krylov.smoothing.{lr_dir}', 'krylov')
    def run():
        import test_torch_krylov as tk
        vm, _, sfield, efield = tk.make_wrapper_problem()
        ref = efield.copy()
        e3.solver.smoothing(vm, sfield, ref, 1, lr_dir)
        return (tk.wrapper_inputs(vm, sfield, efield),
                {'field': np.asarray(ref.field)})


for _lr_dir in (0, 4):
    _smoothing(_lr_dir)


@case('krylov.wrappers', 'krylov')
def jax_wrappers():
    """The residual (field and norm), and for every ``sc_dir`` the
    restriction of the residual (model, source field, zero field) and
    its prolongation onto the fine field."""
    import test_torch_krylov as tk
    from emg3d_tpu import solver
    vm, _, sfield, efield = tk.make_wrapper_problem()
    res = solver.residual(vm, sfield, efield)
    out = {'residual': np.asarray(res.field),
           'residual_norm': solver.residual(vm, sfield, efield, True)}
    for sc_dir in range(4):
        cm, cs, ce = solver.restriction(vm, sfield, res, sc_dir)
        fine = efield.copy()
        solver.prolongation(fine, cs, sc_dir)
        out[f'{sc_dir}'] = {
            'model': {k: np.asarray(getattr(cm, k))
                      for k in ('eta_x', 'eta_y', 'eta_z', 'zeta')},
            'sfield': {'field': np.asarray(cs.field),
                       'shape_cells': cs.grid.shape_cells},
            'efield': {'shape': ce.field.shape},
            'prolonged': np.asarray(fine.field)}
    return tk.wrapper_inputs(vm, sfield, efield), out


# ---------------------------------------------------------------------------
# Line relaxation: tests/test_torch_line.py (the JAX scans not unrolled: the
# unroll changes no arithmetic, only the compile time)
# ---------------------------------------------------------------------------

def _fields(out, before=None):
    """Fields as stored values (``torch_reference.fields`` reads them)."""
    return torch_reference.masked([np.asarray(a) for a in out], before)


def _line_phases(axis, shape, complex_):
    import test_torch_line as tl

    @case(tl.phases_case(axis, shape, complex_), 'line')
    def run():
        from emg3d_tpu.ops import smoothers
        inputs = tl.phases_inputs(axis, shape, complex_)
        prob, colors, _ = inputs

        @functools.partial(jax.jit, static_argnames=('colors',))
        def phases(args, colors):
            return [smoothers.gauss_seidel_line_phase(*args, *c, axis)
                    for c in colors]

        with mock.patch.dict(os.environ, EMG3D_TPU_SCAN_UNROLL='1'):
            out = phases([jax.numpy.asarray(a) for a in prob], colors)
        return inputs, {str(i): _fields(o, prob[:3])
                        for i, o in enumerate(out)}


def _line_cases():
    import test_torch_line as tl
    for complex_ in (True, False):
        for shape in tl.SHAPES:
            for axis in (0, 1, 2):
                _line_phases(axis, shape, complex_)


_line_cases()


@case('line.nu2', 'line')
def _():
    import test_torch_line as tl
    from emg3d_tpu.ops import smoothers
    prob = tl._problem((5, 7, 3), True, seed=12)
    with mock.patch.dict(os.environ, EMG3D_TPU_SCAN_UNROLL='1'):
        out = jax.jit(smoothers.gauss_seidel_line, static_argnums=(13, 14))(
            *[jax.numpy.asarray(a) for a in prob], 2, 1)
    return (prob, 2, 1), _fields(out)


# ---------------------------------------------------------------------------
# The operator: tests/test_torch_ops.py
# ---------------------------------------------------------------------------

@case('ops.amat_residual', 'ops')
def _():
    import test_torch_ops as to
    from emg3d_tpu.ops import operator
    e, s, eta, zeta, h = prob = to._problem()
    model = to._j([*eta, zeta, *h])
    res = operator.residual(*to._j(s), *to._j(e), *model)
    return (prob,), {
        'amat': _fields(operator.amat_x(*to._j(e), *model)),
        'residual': _fields(res),
        'residual_norm': float(operator.residual_norm(*res))}


# ---------------------------------------------------------------------------
# The point Gauss-Seidel phase: tests/test_torch_gs.py
# ---------------------------------------------------------------------------

def _gs_phase(color):
    import test_torch_gs as tg

    @case(tg.phase_case(color), 'gs')
    def run():
        from emg3d_tpu.ops import pallas_gs, smoothers
        prob = tg._random_problem()
        ref = smoothers.gauss_seidel_phase(*tg._jax(*prob), *color)
        spl = pallas_gs.gauss_seidel_phase_split(*tg._jax(*prob), *color)
        return (prob, color), {'phase': _fields(ref, prob[0]),
                               'split': _fields(spl, prob[0])}


def _gs_cases():
    import test_torch_gs as tg
    for color in tg.COLORS:
        _gs_phase(color)


_gs_cases()


@case('gs.sweep', 'gs')
def _():
    """As in the test, the port's sweep works in place on the problem's
    arrays (``torch.from_numpy`` shares them): the reverse sweeps of both
    packages start from the port's forward sweep."""
    import test_torch_gs as tg
    from emg3d_tpu.ops import smoothers
    from emg3d_tpu_torch.ops import smoothers as t_smoothers
    prob, out = tg._random_problem(seed=11), {}
    for reverse in (False, True):
        ref = smoothers.gauss_seidel_sweep(*tg._jax(*prob), reverse)
        out[str(reverse)] = _fields(ref, prob[0])
        t_smoothers.gauss_seidel_sweep(*tg._torch(*prob), reverse)
    return (tg._random_problem(seed=11),), out


# ---------------------------------------------------------------------------
# The level trace: tests/test_torch_cycle_graph.py
# ---------------------------------------------------------------------------

def _trace(cycle):
    @case(f'cycle_graph.trace.{cycle}', 'cycle_graph')
    def run():
        import test_torch_cycle_graph as tc
        from emg3d_tpu import solver
        made = {}
        kw = tc.trace_options(cycle)
        problem = tc.problem((16, 16, 16))
        with mock.patch.object(solver, 'MGParameters', tc.recording(
                made, 'jax', solver.MGParameters)), \
                mock.patch.dict(os.environ, EMG3D_TPU_CYCLE_JIT='0'), \
                contextlib.redirect_stdout(io.StringIO()):
            _, info = solver.solve(*problem, return_info=True, **kw)
        return (*problem, kw), {
            'it_mg': info['it_mg'],
            'level_all': np.asarray(made['jax'].level_all),
            'cycle_qc': solver._cycle_qc(made['jax'])}


for _cycle in ('F', 'W', 'V'):
    _trace(_cycle)


# ---------------------------------------------------------------------------
# North-star configuration 5: tests/test_torch_time_domain.py
# ---------------------------------------------------------------------------

@case('time_domain.16', 'time_domain')
def _():
    import test_torch_time_domain as tt
    times = np.logspace(-2, 1, 13)
    e3.transforms.design_filter.cache_clear()    # designed on one thread
    tresp, fresp, its, freqs = tt.jax_time_domain(16, times, **tt.BAND)
    return (16, times, tt.BAND), {'transient': tresp, 'responses': fresp,
                                  'it_mg': np.asarray(its), 'freqs': freqs}


# ---------------------------------------------------------------------------
# The numpy engines: tests/test_torch_layered.py, tests/test_torch_examples.py
# ---------------------------------------------------------------------------

def _filter(name):
    @case(f'layered.{name}', 'layered')
    def run():
        import test_torch_layered as tl
        key, call = tl.CALLS[name]
        getattr(e3.transforms, name).cache_clear()   # designed on one thread
        out = call(tl.MODS[key][0])
        return (name,), {str(i): a for i, a in enumerate(out)}


for _name in ('design_filter', 'design_hankel_filter'):
    _filter(_name)


@case('examples.transient', 'layered')
def _():
    import test_torch_examples as te
    for name in ('design_filter', 'design_hankel_filter'):
        getattr(e3.transforms, name).cache_clear()
    return te.TRANSIENT, {'transient': te.jax_transient(*te.TRANSIENT)}


# ---------------------------------------------------------------------------
# The inversion: tests/test_torch_inversion.py
# ---------------------------------------------------------------------------

@case('inversion.evaluation', 'inversion')
def _():
    """The JAX package's evaluation of the observed data the port
    computes, as in the test."""
    import test_torch_inversion as ti
    from emg3d_tpu.inversion import native as j_native
    from emg3d_tpu_torch.inversion import native
    observed, _ = ti.evaluate(t3, native)
    _, (synthetic, phi, grad) = ti.evaluate(e3, j_native, observed)
    return ((*ti.evaluation_inputs(), ti.small_survey(t3)),
            {'synthetic': synthetic, 'phi': phi, 'gradient': grad})


@case('inversion.steps', 'inversion')
def _():
    import test_torch_inversion as ti
    model, sfield = ti.steps_problem()
    with mock.patch.dict(os.environ, EMG3D_TPU_CYCLE_JIT='0'):
        out = e3.solve(model, sfield, plain=True, tol=1e-6, return_info=True)
    return (model, sfield), solved(out)


# ---------------------------------------------------------------------------
# The command line: tests/test_torch_cli.py
# ---------------------------------------------------------------------------

@case('cli.gradient', 'cli')
def _():
    import test_torch_cli as tc
    from emg3d_tpu.cli import main as j_cli
    with tempfile.TemporaryDirectory() as path:
        tc.write_inputs(path, observed=True)
        fname = tc.write_cfg(path, device=None, **tc.PARITY)
        j_cli([fname, '-g'])
        out = e3.load(os.path.join(path, 'emg3d_out.h5'), verb=0)
    values = {key: out[key] for key in ('data', 'misfit', 'gradient',
                                        'n_observations')}
    values['keys'] = np.asarray(sorted(out), dtype=str)
    return tc.parity_inputs(), values


# ---------------------------------------------------------------------------
# Simulations: tests/test_torch_sim*.py, tests/test_torch_gridding_survey.py
# ---------------------------------------------------------------------------

def frozen(sim, what='all', drop=('_dict_grid',)):
    """What a JAX simulation stores (``to_dict(what)``, as plain dicts:
    ``Simulation.from_dict`` rebuilds it), without the task dicts in
    ``drop``, its solves' infos cut to ``INFO``.  Without its task grids
    (``gridding='same'``) the rebuilt simulation shares the model's grid
    among its tasks, as the computed one did."""
    out = e3.io._dict_serialize_one(sim.to_dict(what, copy=True))
    for name in drop:
        del out[name]
    for name in ('_dict_efield_info', '_dict_bfield_info'):
        for by_freq in out.get(name, {}).values():
            for freq, info in by_freq.items():
                by_freq[freq] = {key: info[key] for key in INFO}
    return out


@case('sim.pair', 'sim')
def _():
    import test_torch_sim as ts
    jsim = ts.pair_sim(e3)
    values = {'simulation': frozen(jsim),
              'jvec': np.asarray(jsim.jvec(ts.jvec_vector()))}
    # On copies, as in the test: jtvec replaces residual and gradient.
    values['jtvec'] = np.asarray(
        jsim.copy().jtvec(ts.jtvec_weights(ts.pair_sim(t3).copy())))
    return (*ts.make_inputs(t3), ts.jvec_vector()), values


@case('sim.input', 'sim')
def _():
    import test_torch_sim as ts
    model, sim_inp = ts.input_gridding_inputs(e3)
    sim = e3.Simulation(model=model, **sim_inp)
    _ = sim.gradient
    return ts.input_gridding_inputs(t3), {
        'it_mg': sim.get_efield_info('TxED-1', 'f-1')['it_mg'],
        'synthetic': np.asarray(sim.data.synthetic), 'misfit': sim.misfit,
        'gradient': np.asarray(sim.gradient)}


@case('sim_grad.default', 'sim_grad')
def _():
    import test_torch_sim_grad as tg
    model, sim_inp = tg.with_observed(e3, 1.2, **tg.default_options())
    sim = e3.Simulation(model=model, **sim_inp)
    _ = sim.gradient
    return tg.default_inputs(), {
        'simulation': frozen(sim),
        'jvec': np.asarray(sim.jvec(tg.jvec_vector()))}


@case('sim_batch.jax', 'sim_batch')
def _():
    import test_torch_sim_batch as tb
    sim = tb.run(e3, 'batch')
    return tb.jax_inputs(), {'simulation': frozen(sim), 'jvec': sim.jvec_v}


def _gridding(classes):
    @case(f'gridding.{classes}', 'gridding')
    def run():
        import test_torch_gridding_survey as tg
        sim = tg.auto_sim(e3, classes)
        results = tg.run(sim)
        # Fields only where from_emg3d_tpu carries them over.
        drop = ['_dict_bfield']     # the grids are kept
        if classes is False:
            drop.append('_dict_efield')
        return (tg.auto_inputs(t3, classes),), {
            'simulation': frozen(sim, 'computed', drop), 'results': results}


for _classes in (False, 1.7):
    _gridding(_classes)


# ---------------------------------------------------------------------------
# Writing the file.
# ---------------------------------------------------------------------------

def compute(name):
    """The flat arrays of case ``name``, its digest among them, computed
    on one torch and one BLAS thread as in the tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpoolctl.threadpool_limits(limits=1):
            inputs, values = CASES[name].fn()
    finally:
        torch.set_num_threads(threads)
    flat = torch_reference.flatten(values, name)
    flat[f'{name}>{torch_reference.DIGEST}'] = np.asarray(
        torch_reference.digest(*inputs))
    return flat


def write_part(fname, names):
    """Compute ``names`` in this process into ``fname``."""
    flat = {}
    for name in names:
        print(f"[{name}]", flush=True)
        flat.update(compute(name))
    np.savez_compressed(fname, **flat)


def write(fname, flat):
    """The file: an ``.npz`` whose members LZMA compresses (``np.load``
    reads it).  A case's scalars go into one JSON string
    (``torch_reference.SCALARS``); an array equal to one written before
    under another key is written as a reference to that key
    (``torch_reference.SAME``)."""
    scalars, first = {}, {}
    with zipfile.ZipFile(fname, 'w', zipfile.ZIP_LZMA) as npz:
        def put(key, val):
            with npz.open(key + '.npy', 'w') as f:
                np.lib.format.write_array(f, val, allow_pickle=False)

        for key, val in flat.items():
            val = np.asarray(val)
            if val.ndim == 0 and val.dtype.kind in 'biufU':
                case, _, name = key.partition('>')
                scalars.setdefault(case, {})[name] = val.item()
                continue
            seen = first.setdefault((val.dtype.str, val.shape,
                                     val.tobytes()), key)
            put(key, val if seen == key else
                np.asarray(torch_reference.SAME + seen))
        for case, values in scalars.items():
            put(f'{case}>{torch_reference.SCALARS}',
                np.asarray(json.dumps(values)))


def main(names):
    """Compute the cases ``names`` (all if none) group by group; merge
    what succeeded into the file (with ``names``, into its other
    cases)."""
    unknown = set(names) - set(CASES)
    if unknown:
        raise SystemExit(f"Unknown cases {sorted(unknown)}; known: "
                         f"{list(CASES)}")
    merge, names = bool(names), names or list(CASES)
    groups = {}
    for name in names:
        groups.setdefault(CASES[name].group, []).append(name)
    flat = {}
    if merge:
        flat = {key: val for key, val in torch_reference.stored().items()
                if key.split('>')[0] not in names}
    with tempfile.TemporaryDirectory() as tmp:
        parts = [os.path.join(tmp, f'{group}.npz') for group in groups]

        def run(part, members):
            return subprocess.run(
                [sys.executable, __file__, '--part', part, *members]
            ).returncode

        with concurrent.futures.ThreadPoolExecutor(JOBS) as pool:
            codes = list(pool.map(run, parts, groups.values()))
        for part, code in zip(parts, codes):
            if code == 0:
                with np.load(part, allow_pickle=False) as npz:
                    flat.update({k: npz[k] for k in npz.files})
    fname = torch_reference.FNAME
    write(fname, flat)
    print(f"Written {os.path.abspath(fname)}: "
          f"{os.path.getsize(fname) / 2**20:.2f} MiB")
    failed = [g for g, code in zip(groups, codes) if code]
    if failed:
        raise SystemExit(f"Groups {failed} failed; their cases were not "
                         "written.")


if __name__ == '__main__':
    args = sys.argv[1:]
    if args[:1] == ['--part']:
        write_part(args[1], args[2:])
    else:
        main(args)
