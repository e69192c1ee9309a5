"""CLI job execution: build a Simulation from config, compute, persist.

Copy of ``emg3d_tpu.cli.run`` for the PyTorch port: the config's
``device`` places the Simulation (no key: the CUDA card), and a
simulation resumed with ``--load`` moves to that device when the config
names one (else it stays on the device it was stored with).  The log
file also lists the iterations of every solve.  The text below is the
JAX package's.

Drives the same forward/misfit/gradient batch jobs as the reference CLI
(emg3d/cli/run.py:32-284) — same config surface, same output files —
structured as a staged pipeline: validate inputs, open the job log,
acquire the simulation (fresh or from file), run the requested
function, persist results.
"""

import json
import logging
import os
import sys
import time

import numpy as np

from emg3d_tpu_torch import io, models, simulations, utils
from emg3d_tpu_torch.cli import parser

__all__ = ['simulation']

# Gradient shapes per anisotropy case: leading parameter axis.
_CASE_AXES = {'HTI': 2, 'VTI': 2, 'triaxial': 3}


class _JobLog:
    """File (DEBUG) + console logging with the CLI's formatting habits.

    ``section`` prints the ``::  NAME ::`` banners; ``result`` logs the
    first line of an io/save info string at INFO and the remainder at
    DEBUG (the files' summary-vs-detail convention).
    """

    def __init__(self, logfile, verbosity):
        log = logging.getLogger('emg3d_tpu_torch.cli')
        log.setLevel(logging.DEBUG)
        fmt = logging.Formatter('{message}', style='{')

        # Replace handlers from any previous run in this process.
        for old in list(log.handlers):
            if old.name in ('emg3d_fh', 'emg3d_ch'):
                log.removeHandler(old)
            old.close()

        to_file = logging.FileHandler(logfile, mode='w')
        to_file.setLevel(logging.DEBUG)
        to_file.setFormatter(fmt)
        to_file.set_name('emg3d_fh')

        to_term = logging.StreamHandler()
        to_term.setLevel(
            {-1: logging.ERROR, 0: logging.WARNING,
             1: logging.INFO, 2: logging.DEBUG}[verbosity])
        to_term.setFormatter(fmt)
        to_term.set_name('emg3d_ch')

        for handler in (to_file, to_term):
            log.addHandler(handler)

        logging.captureWarnings(True)
        wlog = logging.getLogger('py.warnings')
        wlog.setLevel(logging.DEBUG)
        for old in list(wlog.handlers):     # stale handlers of prior runs
            if old.name in ('emg3d_fh', 'emg3d_ch'):
                wlog.removeHandler(old)
        for handler in (to_file, to_term):
            wlog.addHandler(handler)

        self._log = log

    def __getattr__(self, name):            # info/debug/warning/...
        return getattr(self._log, name)

    def section(self, name, trailing=True):
        self._log.info(f"\n    :: {name} ::" + ("\n" if trailing else ""))

    def result(self, info_str):
        first, _, rest = info_str.partition('\n')
        self._log.info(first)
        self._log.debug(rest)


def simulation(args_dict):
    """Run one CLI batch job (forward / misfit / gradient)."""
    timer = utils.Timer()
    cfg, term = parser.parse_config_file(args_dict)
    _require_inputs(cfg, term)

    job = term['function']
    log = _JobLog(cfg['files']['log'], term['verbosity'])

    from emg3d_tpu_torch import __version__
    log.info(f":: emg3d-torch CLI {job} START :: {time.asctime()} "
             f":: v{__version__}")
    log.debug(f"{utils.Report()}")
    log.debug("\n    :: CONFIGURATION ::\n")
    log.debug(term['config_file'] + "\n" + json.dumps(
        cfg, sort_keys=True, indent=4, default=str))

    sim = _acquire_simulation(cfg, term, log)

    log.section("SIMULATION", trailing=False)
    log.info(f"\n{sim}\n")
    log.debug("    :: MESHES ::\n")
    log.debug(sim.print_grid_info(return_info=True))

    output = _execute(sim, cfg, term, log)
    output['configuration'] = cfg

    _persist(sim, cfg, output, log)
    log.info(f"\n:: emg3d-torch CLI {job} END   :: {time.asctime()} "
             f":: runtime = {timer.runtime}")


# ------------------------------ stages ------------------------------

def _require_inputs(cfg, term):
    """Exit with a collected error message if any input is missing."""
    problems = []

    config = term['config_file']
    if config != '.' and not os.path.isfile(config):
        problems.append(f"Config file not found: {config}")

    resuming = bool(cfg['files']['load'])
    needed = []
    if not resuming:
        needed += [('Survey', cfg['files']['survey']),
                   ('Model', cfg['files']['model'])]
    elif term.get('clean'):
        needed += [('Model', cfg['files']['model'])]
    if resuming:
        needed += [('Simulation', cfg['files']['load'])]
    for label, fname in needed:
        if fname and not os.path.isfile(fname):
            problems.append(f"{label} file not found: {fname}")

    out_dirs = {os.path.dirname(cfg['files']['log'])}
    if cfg['files']['save']:
        out_dirs.add(os.path.dirname(cfg['files']['save']))
    for dname in sorted(out_dirs):
        if not os.path.isdir(dname):
            problems.append(f"Output directory does not exist: {dname}")

    if problems:
        sys.exit("\n".join(f"* ERROR   :: {p}" for p in problems))


def _acquire_simulation(cfg, term, log):
    """A ready-to-run Simulation: loaded from file, or built fresh."""
    opts = cfg['simulation_options']

    if cfg['files']['load']:
        log.section("LOAD SIMULATION")
        sim, info = _load_simulation(cfg['files']['load'],
                                     opts.get('device'))
        log.result(info)

        if term['clean']:
            log.section("CLEAN DATA AND REPLACE MODEL")
            sim.clean('computed')
            loaded, minfo = io.load(cfg['files']['model'], verb=-1)
            log.result(minfo)
            sim.model = loaded['model']

            gopts = opts.get('gridding_opts', {})
            expand = gopts.pop('expand', None)
            if expand is not None:
                sim.model = models.expand_grid_model(
                    sim.model, expand, gopts.pop('seasurface', 0.0))

        wanted = opts.get('layered', False)
        if sim.layered != wanted:
            log.info(f"Change «layered» of simulation to {wanted}.")
            sim.layered = wanted
        return sim

    log.section("LOAD SURVEY AND MODEL")
    loaded, sinfo = io.load(cfg['files']['survey'], verb=-1)
    survey = loaded['survey']
    log.result(sinfo)
    loaded, minfo = io.load(cfg['files']['model'], verb=-1)
    log.result(minfo)

    subset = cfg['data']
    if subset:
        survey = survey.select(
            sources=subset.get('sources', None),
            receivers=subset.get('receivers', None),
            frequencies=subset.get('frequencies', None),
            remove_empty=subset.get('remove_empty', False))

    if term['verbosity'] < 1:
        opts['tqdm_opts'] = False

    return simulations.Simulation(
        survey=survey, model=loaded['model'], verb=-1, **opts)


def _load_simulation(fname, device):
    """(Simulation, info string) stored in ``fname``; on ``device`` if it
    is not None, else on the device it was stored with.  The device is
    set before the Simulation is made, so that a simulation stored on the
    card loads onto the CPU of a host without one."""
    if device is None:
        return simulations.Simulation.from_file(fname, verb=-1)
    data, info = io._read(fname)
    return io._dict_deserialize({**data['simulation'], 'device': device}), info


def _iterations(sim, field):
    """One line per task of ``field`` ('efield' or 'bfield'): its solver's
    iterations and final relative error."""
    lines = []
    for src, freq in sim._srcfreq:
        info = sim._dict_get(f"{field}_info", src, freq)
        if info is not None:
            lines.append(f"   {field} {src} / {freq}: it_ssl "
                         f"{info['it_ssl']}, it_mg {info['it_mg']}, "
                         f"rel_error {info['rel_error']!r}")
    return "\n".join(lines)


def _execute(sim, cfg, term, log):
    """Run the requested function; return the output payload."""
    job, dry = term['function'], term.get('dry_run', False)
    out = {}

    log.info("    :: FORWARD COMPUTATION ::\n")
    if dry:
        out['data'] = np.zeros(sim.survey.shape, dtype=complex)
    elif job == 'forward':
        sim.compute(observed=True, **cfg['noise_kwargs'])
        out['data'] = np.asarray(sim.data.observed)
    else:
        sim.compute()
        out['data'] = np.asarray(sim.data.synthetic)
    if not dry:
        if term['verbosity'] in (0, 1):
            sim.print_solver_info('efield', 0)
        log.debug(sim.print_solver_info('efield', 1, True))
        log.debug(_iterations(sim, 'efield'))

    if job in ('misfit', 'gradient'):
        out['misfit'] = 0.0 if dry else sim.misfit
        out['n_observations'] = sim.survey.count

    if job == 'gradient':
        log.section("BACKWARD COMPUTATION")
        if dry:
            naxes = _CASE_AXES.get(sim.model.case)
            shape = sim.model.shape if naxes is None else (
                naxes, *sim.model.shape)
            out['gradient'] = np.zeros(shape)
        else:
            out['gradient'] = sim.gradient
            if term['verbosity'] in (0, 1):
                sim.print_solver_info('bfield', 0)
            log.debug(sim.print_solver_info('bfield', 1, True))
            log.debug(_iterations(sim, 'bfield'))

    return out


def _persist(sim, cfg, output, log):
    log.info("    :: SAVE RESULTS ::\n")
    if cfg['files']['save']:
        log.result(sim.to_file(cfg['files']['save'], verb=-1))
    log.result(io.save(cfg['files']['output'], **output, verb=-1))
