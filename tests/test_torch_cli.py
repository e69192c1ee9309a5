"""PyTorch port, ``emg3d_tpu_torch.cli`` (``emg3d-torch``, ``python -m
emg3d_tpu_torch``) against ``emg3d_tpu.cli``.

- The tests of tests/test_cli.py on the port, with ``device = cpu`` in
  the config's ``[simulation]`` section (the port's only way to ask for
  the CPU; no key means the CUDA card, and on a host without one the run
  raises ``RuntimeError``).
- Parity: one survey (with observed data) and one model at 16^3, written
  with ``emg3d_tpu.save``, through the JAX CLI once (``-g``; its output
  read from tests/data/torch_reference.npz, written by
  tests/create_data/torch_reference.py from the JAX package) and through
  the port's CLI with ``-f``, ``-m`` and ``-g`` (plain F-cycles, tol 1e-5,
  as in tests/test_cli.py): data, misfit and gradient to 1e-10 relative
  to the largest entry (complex128 both).
- Resuming: ``--load`` takes the config's device when one is given, else
  the device the simulation was stored with; ``--cache`` and ``--clean``.
- The entry points: ``python -m emg3d_tpu_torch --version`` and
  ``--report`` in a process where ``jax``, ``emg3d_tpu`` and ``h5py``
  cannot be imported; the console script of ``pyproject.toml``.
"""

import json
import os
import pathlib
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import threadpoolctl
import torch
from numpy.testing import assert_allclose

import emg3d_tpu as e3
import emg3d_tpu_torch as t3
from emg3d_tpu import electrodes, meshes, surveys
from emg3d_tpu_torch.cli import main as cli
from emg3d_tpu_torch.cli import parser as cli_parser
from torch_reference import reference

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def default_args():
    """args_dict as produced by the argparse front end."""
    return {
        'config': 'emg3d.cfg', 'nproc': None, 'forward': False,
        'misfit': False, 'gradient': False, 'path': None, 'survey': None,
        'model': None, 'output': None, 'save': None, 'load': None,
        'cache': None, 'clean': False, 'layered': None, 'dry_run': False,
        'verbosity': 0,
    }


def write_inputs(path, nx=16, observed=False, prop=1.0):
    """Survey + model files (``emg3d_tpu.save``, .h5) for a tiny
    fullspace run; ``observed`` gives the survey observed data made from
    a seed."""
    survey, model = make_inputs(nx, observed, prop)
    e3.save(os.path.join(path, 'survey.h5'), survey=survey, verb=0)
    e3.save(os.path.join(path, 'model.h5'), model=model, verb=0)


def make_inputs(nx=16, observed=False, prop=1.0):
    """The survey and model of ``write_inputs``."""
    h = np.ones(nx) * 100.0
    grid = meshes.TensorMesh([h, h, h], origin=(-nx * 50.,) * 3)
    model = e3.Model(grid, property_x=prop)

    src = electrodes.TxElectricDipole((0., 0., 0., 0., 0.))
    recs = [electrodes.RxElectricPoint((x, 50., 0., 0., 0.))
            for x in [250., 350.]]
    data = None
    if observed:
        rng = np.random.default_rng(8)
        data = 1e-8 * (rng.uniform(0.5, 1.5, (1, 2, 1))
                       + 1j * rng.uniform(-0.3, 0.3, (1, 2, 1)))
    survey = surveys.Survey([src], recs, [1.0], relative_error=0.05,
                            data=data)
    return survey, model


def write_cfg(path, extra="", device="cpu", tol=1e-3, simulation=""):
    """The config of tests/test_cli.py, with ``device`` in [simulation]
    (none if ``device`` is None) and more lines there from ``simulation``;
    ``tol`` 1e-3 by default, where only what the CLI does around the
    solves is tested (each cycle of the CPU's plain version takes long)."""
    dev = "" if device is None else f"device = {device}"
    cfg = f"""[files]
path = {path}

[simulation]
name = CLI test
{dev}
{simulation}

[solver_opts]
plain = True
tol = {tol}
verb = 0
{extra}
"""
    fname = os.path.join(path, 'emg3d.cfg')
    with open(fname, 'w') as f:
        f.write(cfg)
    return fname


NO_NOISE = "\n[noise_opts]\nadd_noise = False\n"


class TestParser:

    def test_defaults_no_config(self, tmp_path):
        args = default_args()
        args['config'] = '.'
        args['path'] = str(tmp_path)
        cfg, term = cli_parser.parse_config_file(args)
        assert term['function'] == 'forward'
        assert cfg['files']['survey'].endswith('survey.h5')
        assert cfg['files']['model'].endswith('model.h5')
        assert cfg['files']['output'].endswith('emg3d_out.h5')
        assert cfg['files']['log'].endswith('emg3d_out.log')
        assert not cfg['files']['save']
        assert 'device' not in cfg['simulation_options']
        assert cfg['simulation_options']['name'] == 'emg3d-torch CLI run'

    def test_terminal_overrides(self, tmp_path):
        args = default_args()
        args.update(config='.', path=str(tmp_path), survey='ss',
                    model='mm.json', output='out.npz', gradient=True,
                    nproc=7, cache='c1')
        cfg, term = cli_parser.parse_config_file(args)
        assert term['function'] == 'gradient'
        assert cfg['files']['survey'].endswith('ss.h5')
        assert cfg['files']['model'].endswith('mm.json')
        assert cfg['files']['output'].endswith('out.npz')
        # cache sets save; load only once the file exists (resume).
        assert cfg['files']['save'].endswith('c1.h5')
        assert cfg['files']['load'] is False
        assert cfg['simulation_options']['max_workers'] == 7
        # gradient forces linear receiver interpolation.
        assert cfg['simulation_options'][
            'receiver_interpolation'] == 'linear'

    def test_config_sections(self, tmp_path):
        fname = write_cfg(str(tmp_path), extra="""
[gridding_opts]
frequency = 0.5
mapping = Conductivity
domain = -1000, 1000; -2000, 2000; None

[noise_opts]
add_noise = False

[data]
sources = TxED-1
remove_empty = False
""")
        args = default_args()
        args['config'] = fname
        cfg, term = cli_parser.parse_config_file(args)
        gopts = cfg['simulation_options']['gridding_opts']
        assert gopts['frequency'] == 0.5
        assert gopts['mapping'] == 'Conductivity'
        assert gopts['domain']['x'] == [-1000., 1000.]
        assert gopts['domain']['z'] is None
        assert cfg['noise_kwargs'] == {'add_noise': False}
        assert cfg['data']['sources'] == ['TxED-1']
        assert cfg['simulation_options']['solver_opts']['tol'] == 1e-3
        assert cfg['simulation_options']['device'] == 'cpu'

    @pytest.mark.parametrize('raw,expected', [("True", True), ("1.7", 1.7)])
    def test_shape_classes_values(self, tmp_path, raw, expected):
        fname = os.path.join(str(tmp_path), 'sc.cfg')
        with open(fname, 'w') as f:
            f.write(f"[files]\npath = {tmp_path}\n"
                    f"[simulation]\nshape_classes = {raw}\n")
        args = default_args()
        args['config'] = fname
        cfg, _ = cli_parser.parse_config_file(args)
        assert cfg['simulation_options']['shape_classes'] == expected

    def test_unknown_keys_raise(self, tmp_path):
        fname = os.path.join(str(tmp_path), 'bad.cfg')
        with open(fname, 'w') as f:
            f.write("[solver_opts]\nnonsense = 1\n")
        args = default_args()
        args['config'] = fname
        with pytest.raises(TypeError, match='solver_opts'):
            cli_parser.parse_config_file(args)


@pytest.mark.parametrize('ext', ['.h5', '.npz', '.json'])
def test_configuration_round_trip(tmp_path, ext):
    """The output file's ``configuration`` (a nested dict with None,
    booleans and lists) comes back from every format as it does through
    the JAX package's ``save`` and ``load``: as it went in, but for the
    empty dicts, which ``.npz`` has no entry for."""
    fname = write_cfg(str(tmp_path), extra="""
[gridding_opts]
domain = -1000, 1000; -2000, 2000; None
center_on_edge = True
""" + NO_NOISE)
    args = default_args()
    args.update(config=fname, gradient=True)
    cfg, _ = cli_parser.parse_config_file(args)
    backs = []
    for pkg in (t3, e3):
        out = str(tmp_path / f'out_{pkg.__name__}{ext}')
        pkg.save(out, configuration=cfg, verb=0)
        backs.append(pkg.load(out)['configuration'])

    def plain(d, drop_empty=False):
        d = json.loads(json.dumps(
            d, default=lambda v: v.tolist() if hasattr(v, 'tolist')
            else v, sort_keys=True))
        if drop_empty:
            d = {k: v for k, v in d.items() if v != {}}
        return d

    assert plain(backs[0]) == plain(backs[1])
    assert plain(backs[0]) == plain(cfg, drop_empty=ext == '.npz')


class TestMain:

    @pytest.mark.parametrize('flag,expected', [
        ('--version', 'emg3d-torch v'), ('--report', 'torch')])
    def test_version_and_report(self, capsys, flag, expected):
        cli([flag])
        assert expected in capsys.readouterr().out

    @pytest.mark.parametrize('flag,expected', [
        ('--version', 'emg3d-torch v'), ('--report', 'h5py: not installed')])
    def test_module_without_jax(self, flag, expected):
        """``python -m emg3d_tpu_torch`` where neither JAX, the JAX package
        nor h5py can be imported (the card's host has none of them)."""
        code = ("import runpy, sys\n"
                "for name in ('jax', 'emg3d_tpu', 'h5py'):\n"
                "    sys.modules[name] = None\n"
                f"sys.argv = ['emg3d_tpu_torch', {flag!r}]\n"
                "runpy.run_module('emg3d_tpu_torch', run_name='__main__')\n")
        out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert expected in out.stdout

    def test_console_script(self):
        """``emg3d-torch`` of pyproject.toml is the port's ``main``; the
        JAX package's ``emg3d-tpu`` stays."""
        with open(ROOT / 'pyproject.toml', 'rb') as f:
            scripts = tomllib.load(f)['project']['scripts']
        assert scripts['emg3d-torch'] == 'emg3d_tpu_torch.cli.main:main'
        assert scripts['emg3d-tpu'] == 'emg3d_tpu.cli.main:main'
        module, name = scripts['emg3d-torch'].split(':')
        assert getattr(__import__(module, fromlist=[name]), name) is cli

    def test_dry_run(self, tmp_path):
        path = str(tmp_path)
        write_inputs(path)
        fname = write_cfg(path)
        cli([fname, '--dry-run', '-g'])
        out = t3.load(os.path.join(path, 'emg3d_out.h5'), verb=0)
        assert np.all(out['data'] == 0.0)
        assert out['misfit'] == 0.0
        assert np.all(out['gradient'] == 0.0)
        assert os.path.isfile(os.path.join(path, 'emg3d_out.log'))

    def test_missing_files_exit(self, tmp_path):
        path = str(tmp_path)
        fname = write_cfg(path)
        with pytest.raises(SystemExit, match='not found'):
            cli([fname, '--dry-run'])

    def test_no_device_without_card_raises(self, tmp_path, monkeypatch):
        """No ``device`` key means the card: on a host without one the
        run raises and nothing runs on the CPU."""
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        path = str(tmp_path)
        write_inputs(path)
        fname = write_cfg(path, device=None)
        with pytest.raises(RuntimeError, match='cuda'):
            cli([fname, '-f'])

    def test_forward_run(self, tmp_path):
        path = str(tmp_path)
        write_inputs(path)
        fname = write_cfg(path, extra=NO_NOISE)
        cli([fname, '-f', '--save', 'mysim.json', '--output', 'out.npz'])

        out = t3.load(os.path.join(path, 'out.npz'), verb=0)
        assert np.all(np.isfinite(out['data']))
        assert out['data'].shape == (1, 2, 1)

        # The saved simulation can be reloaded and has the data.
        sim = t3.Simulation.from_file(os.path.join(path, 'mysim.json'))
        assert sim.device == 'cpu'
        np.testing.assert_allclose(
            np.asarray(sim.data.observed), out['data'])

        # The log lists the iterations of the solve.
        with open(os.path.join(path, 'out.log')) as f:
            log = f.read()
        assert 'emg3d-torch CLI forward END' in log
        assert 'efield TxED-1 / f-1: it_ssl 0, it_mg ' in log

    def test_gradient_run_with_cache(self, tmp_path):
        path = str(tmp_path)
        write_inputs(path)
        fname = write_cfg(path, extra=NO_NOISE)

        # Forward first, creating the cache.
        cli([fname, '-f', '--cache', 'cache'])

        # Observed exist now; misfit run from cache.
        cli([fname, '-m', '--cache', 'cache'])
        out = t3.load(os.path.join(path, 'emg3d_out.h5'), verb=0)
        assert 'misfit' in out
        assert out['n_observations'] == 2


def _stored_simulation(path, device):
    """A simulation stored as ``stored.json`` (made on the CPU) whose
    stored device is ``device``."""
    write_inputs(path)
    loaded = t3.load(os.path.join(path, 'survey.h5'))
    model = t3.load(os.path.join(path, 'model.h5'))['model']
    sim = t3.Simulation(loaded['survey'], model, device='cpu',
                        solver_opts={'plain': True, 'tol': 1e-5})
    fname = os.path.join(path, 'stored.json')
    sim.to_file(fname, verb=0)
    with open(fname) as f:
        content = json.load(f)
    content['simulation']['device'] = device
    content['simulation']['solver_opts']['device'] = device
    with open(fname, 'w') as f:
        json.dump(content, f)


@pytest.mark.parametrize('stored,config,expected', [
    ('cpu', None, 'cpu'),          # the stored device, without a key
    ('cuda', 'cpu', 'cpu'),        # the config's device wins
    ('cuda', None, RuntimeError),  # stored on the card, no card here
])
def test_load_takes_the_configs_device(tmp_path, monkeypatch, stored,
                                       config, expected):
    """``--load``: a config's ``device`` places the loaded simulation;
    without one it stays on the device it was stored with."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    path = str(tmp_path)
    _stored_simulation(path, stored)
    fname = write_cfg(path, device=config)
    args = [fname, '-d', '--load', 'stored.json', '--save', 'after.json']
    if expected is RuntimeError:
        with pytest.raises(RuntimeError, match='cuda'):
            cli(args)
        return
    cli(args)
    sim = t3.load(os.path.join(path, 'after.json'))['simulation']
    assert sim.device == expected
    assert sim.solver_opts['device'] == expected


def test_clean_replaces_the_model(tmp_path):
    """``--load ... --clean`` drops what was computed and takes the
    config's model file."""
    path = str(tmp_path)
    _stored_simulation(path, 'cpu')
    write_inputs(path, prop=3.0)            # a new model.h5
    fname = write_cfg(path)
    cli([fname, '-d', '--load', 'stored.json', '--clean', '--save',
         'after.json'])
    sim = t3.load(os.path.join(path, 'after.json'))['simulation']
    assert np.all(sim.model.property_x == 3.0)
    assert np.all(np.isnan(np.asarray(sim.data.synthetic)))


# The parity runs: the model's 16^3 grid, and linear receiver
# interpolation also for ``-f`` (``-m`` and ``-g`` force it), so that
# one JAX run (``-g``) serves all three.
PARITY = dict(tol=1e-5, extra=NO_NOISE, simulation=(
    "gridding = same\nreceiver_interpolation = linear"))


def parity_inputs():
    """What the JAX CLI's ``-g`` run depends on: the inputs, the config's
    options (no ``device``) and the flag."""
    return (*make_inputs(observed=True), PARITY, None, '-g')


@pytest.fixture(scope='module')
def jax_cli_run(tmp_path_factory):
    """The output of the JAX CLI's ``-g`` run on the 16^3 survey with
    observed data (its keys, and the values of ``data``, ``misfit``,
    ``gradient`` and ``n_observations``), and the directory of its input
    files."""
    path = str(tmp_path_factory.mktemp('jax_cli'))
    write_inputs(path, observed=True)
    stored = reference('cli.gradient', *parity_inputs())
    return {key: stored.get(key) for key in stored['keys']}, path


@pytest.mark.parametrize('flag', ['-f', '-m', '-g'])
def test_port_cli_equals_jax_cli(jax_cli_run, tmp_path, flag):
    """The port's CLI on the CPU against the JAX CLI on the same files:
    data (``-f``: observed without noise, i.e. synthetic), misfit and
    gradient to 1e-10 relative to the largest entry."""
    ref, inputs = jax_cli_run
    path = str(tmp_path)
    fname = write_cfg(path, **PARITY)
    cli([fname, flag, '--survey', os.path.join(inputs, 'survey.h5'),
         '--model', os.path.join(inputs, 'model.h5')])
    out = t3.load(os.path.join(path, 'emg3d_out.h5'), verb=0)
    keys = {'-f': ['data'], '-m': ['data', 'misfit'],
            '-g': ['data', 'misfit', 'gradient']}[flag]
    assert sorted(k for k in out if k in ref) == sorted(
        keys + (['n_observations'] if flag != '-f' else []) +
        ['configuration'])
    for key in keys:
        a, b = np.asarray(out[key]), np.asarray(ref[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert np.all(np.isfinite(a)), key
        assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max(),
                        err_msg=key)
