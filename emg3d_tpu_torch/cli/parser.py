"""CLI configuration: ``emg3d.cfg`` INI schema + terminal overrides.

Copy of ``emg3d_tpu.cli.parser`` for the PyTorch port, with one key more
in ``[simulation]``: ``device`` (``Simulation(device=...)``; no key means
the CUDA card).  The text below is the JAX package's.

The INI *surface* is format-compatible with the reference CLI
(emg3d/cli/parser.py:26-455): sections ``[files]``, ``[simulation]``,
``[solver_opts]``, ``[gridding_opts]``, ``[noise_opts]``, ``[layered]``,
``[data]``; terminal arguments overrule config-file values.

The implementation is schema-driven: every section is a ``{key:
converter}`` table fed through one engine (:func:`_take`) that converts
known keys and rejects unknown ones, instead of per-key imperative
plumbing.  Adding a config option means adding one table row.
"""

import configparser
import os
import warnings
from pathlib import Path

__all__ = ['parse_config_file']

# Accepted data-file extensions; anything else defaults to HDF5.
_EXTENSIONS = ('.h5', '.json', '.npz')

_BOOL_STATES = configparser.ConfigParser.BOOLEAN_STATES


# -------------------------- value converters --------------------------

def _bool(raw):
    try:
        return _BOOL_STATES[raw.strip().lower()]
    except KeyError:
        raise ValueError(f"Not a boolean: {raw!r}") from None


def _floats(raw):
    """Comma-separated floats -> list."""
    return [float(v) for v in raw.split(',')]


def _strings(raw):
    """Comma-separated strings -> stripped list (empties dropped)."""
    return [v.strip() for v in raw.split(',') if v.strip()]


def _xyz(raw):
    """Per-direction value: ``;``-separated x;y;z parts.

    Each part is ``None``/``True``/``False`` or a comma-separated float
    list; a single part applies to all directions, three parts become
    an ``{'x': ..., 'y': ..., 'z': ...}`` dict.
    """
    def one(part):
        low = part.lower()
        if 'none' in low:
            return None
        if 'true' in low:
            return True
        if 'false' in low:
            return False
        return _floats(part)

    parts = [one(p) for p in raw.split(';')]
    if len(parts) == 1:
        return parts[0]
    return dict(zip('xyz', parts))


# ---------------------------- section specs ----------------------------
#
# {ini-key: converter}; `_take` applies the converter to each present
# key and raises TypeError for any key not in the spec.

_SOLVER_SPEC = {
    'sslsolver': _bool, 'semicoarsening': _bool, 'linerelaxation': _bool,
    'plain': _bool, 'cycle': str, 'tol': float, 'tol_gradient': float,
    'verb': int, 'maxit': int, 'nu_init': int, 'nu_pre': int,
    'nu_coarse': int, 'nu_post': int, 'clevel': int,
}

_NOISE_SPEC = {
    'min_offset': float, 'max_offset': float, 'mean_noise': float,
    'ntype': str, 'add_noise': _bool,
}

_DATA_SPEC = {
    'sources': _strings, 'receivers': _strings, 'frequencies': _strings,
    'remove_empty': _bool,
}

_GRIDDING_SPEC = {
    'properties': _floats, 'center': _floats, 'cell_number': _floats,
    'min_width_pps': _floats, 'expand': _floats,
    'domain': _xyz, 'distance': _xyz, 'stretching': _xyz,
    'min_width_limits': _xyz, 'center_on_edge': _xyz,
    'mapping': str, 'vector': str,
    'frequency': float, 'seasurface': float, 'max_buffer': float,
    'lambda_factor': float, 'lambda_from_center': _bool, 'verb': int,
}

_LAYERED_SPEC = {
    'method': str, 'merge': _bool,
    'radius': float, 'minor': float, 'factor': float, 'check_foci': _bool,
}

def _shape_classes(value):
    """shape_classes: bool flag or a float max-growth bound."""
    try:
        return _bool(value)
    except (ValueError, TypeError):
        return float(value)


_SIMULATION_SPEC = {
    'max_workers': int, 'layered': _bool, 'gridding': str,
    'file_dir': str, 'name': str, 'receiver_interpolation': str,
    'shape_classes': _shape_classes, 'device': str,
    # Deprecated location for noise options (belong in [noise_opts]).
    'min_offset': float, 'max_offset': float, 'mean_noise': float,
    'ntype': str,
}


def _take(cfg, section, spec):
    """Convert a section through its spec; reject unknown keys."""
    if section not in cfg.sections():
        return {}
    raw = dict(cfg.items(section))
    out = {}
    for key, conv in spec.items():
        if key in raw:
            out[key] = conv(raw.pop(key))
    if raw:
        raise TypeError(
            f"Unexpected parameter in [{section}]: {list(raw)}.")
    return out


# --------------------------- main entry point ---------------------------

def parse_config_file(args_dict):
    """Read the config file, apply terminal overrides.

    Returns ``(cfg, term)``: ``cfg`` holds ``files``,
    ``simulation_options``, ``data`` and ``noise_kwargs``; ``term`` the
    terminal-level switches (function, verbosity, dry_run, clean,
    config_file).
    """
    args = dict(args_dict)

    cfg = configparser.ConfigParser(inline_comment_prefixes='#')
    config = args.pop('config')
    config_file = os.path.abspath(config)
    if os.path.isfile(config_file):
        with open(config_file) as f:
            cfg.read_file(f)
    elif config == '.':
        config_file = config    # '.' => deliberately no config file.

    # --- terminal switches -------------------------------------------
    funcs = [f for f in ('forward', 'misfit', 'gradient') if args.pop(f)]
    term = {
        'config_file': config_file,
        'function': funcs[0] if funcs else 'forward',
        'verbosity': int(_clip(args.pop('verbosity'), -1, 2)),
        'dry_run': args.pop('dry_run'),
        'clean': args.pop('clean'),
    }
    nproc = args.pop('nproc')
    layered = args.pop('layered')
    file_overrides = {k: args.pop(k) for k in
                      ('path', 'survey', 'model', 'output', 'save',
                       'load', 'cache')}
    if args:
        raise TypeError(
            f"Unexpected parameter in **args_dict: {list(args)}.")

    # --- [files] ------------------------------------------------------
    files = _resolve_files(cfg, file_overrides)

    # --- [simulation] (+ deprecated noise keys) -----------------------
    sim = _take(cfg, 'simulation', _SIMULATION_SPEC)
    noise_kwargs = {k: sim.pop(k) for k in
                    ('min_offset', 'max_offset', 'mean_noise', 'ntype')
                    if k in sim}
    if noise_kwargs:
        warnings.warn(
            "emg3d: noise options belong in their own section "
            "[noise_opts]; providing them in [simulation] is deprecated.",
            FutureWarning)

    if nproc is not None:
        sim['max_workers'] = max(int(nproc), 1)
    if layered is not None:
        sim['layered'] = layered
    sim.setdefault('name', 'emg3d-torch CLI run')
    if ('receiver_interpolation' not in sim
            and term['function'] == 'gradient'):
        sim['receiver_interpolation'] = 'linear'  # gradient needs linear

    # --- [noise_opts] (authoritative location) ------------------------
    noise_kwargs.update(_take(cfg, 'noise_opts', _NOISE_SPEC))

    # --- [layered] -> simulation layered_opts -------------------------
    layered_opts = _take(cfg, 'layered', _LAYERED_SPEC)
    ellipse = {k: layered_opts.pop(k) for k in
               ('radius', 'minor', 'factor', 'check_foci')
               if k in layered_opts}
    if ellipse:
        layered_opts['ellipse'] = ellipse
    if layered_opts:
        sim['layered_opts'] = layered_opts

    # --- [solver_opts] / [gridding_opts] -> nested options ------------
    for section, spec, dest in (
            ('solver_opts', _SOLVER_SPEC, 'solver_opts'),
            ('gridding_opts', _GRIDDING_SPEC, 'gridding_opts')):
        opts = _take(cfg, section, spec)
        if opts:
            sim[dest] = opts

    # --- [data] -------------------------------------------------------
    data = _take(cfg, 'data', _DATA_SPEC)
    # Empty selection strings mean "no selection".
    data = {k: v for k, v in data.items() if v or k == 'remove_empty'}

    out = {'files': files, 'simulation_options': sim, 'data': data,
           'noise_kwargs': noise_kwargs}
    return out, term


def _clip(value, lo, hi):
    return min(max(value, lo), hi)


def _resolve_files(cfg, overrides):
    """Absolute data-file paths: terminal > config > defaults.

    Every name gets an accepted extension (default ``.h5``); the log
    file always sits next to the output file.  ``cache`` is resume
    shorthand: always save to it, load from it only once it exists.
    """
    section = dict(cfg.items('files')) if 'files' in cfg.sections() else {}

    path = overrides['path'] or section.pop('path', '.')
    path = os.path.abspath(path)

    defaults = {'survey': 'survey', 'model': 'model',
                'output': 'emg3d_out', 'save': False, 'load': False,
                'cache': False}
    files = {}
    logfile = os.path.join(path, 'emg3d_out.log')
    for key, default in defaults.items():
        name = overrides.get(key)
        if name is None:
            name = section.pop(key, default)
        if not name:
            files[key] = False
            continue
        fpath = Path(path, name)
        if fpath.suffix not in _EXTENSIONS:
            fpath = fpath.with_suffix('.h5')
        if key == 'output':
            logfile = str(fpath.with_suffix('.log'))
        files[key] = str(fpath)

    if section:
        raise TypeError(
            f"Unexpected parameter in [files]: {list(section)}.")

    cache = files.pop('cache')
    if cache:
        files['save'] = cache
        files['load'] = cache if os.path.isfile(cache) else False
    files['log'] = logfile
    return files
