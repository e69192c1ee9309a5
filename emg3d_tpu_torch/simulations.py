"""Simulation: multi-source, multi-frequency surveys and their adjoints.

Port of ``emg3d_tpu.simulations``, itself an API-parity rebuild of the
reference's emg3d/simulations.py (each method cites its reference
lines).  Differences by design:

- Per-(source, frequency) tasks are device work, not host processes: the
  reference's ProcessPoolExecutor fan-out (simulations.py:860-866) becomes
  a host-driven loop over the device solver via
  :mod:`emg3d_tpu_torch.parallel.tasks` (``parallel='task'``), or one
  batched solve per grid-sharing group of tasks via
  :mod:`emg3d_tpu_torch.parallel.batch` (``parallel='batch'``: the tasks
  are a leading axis of every field tensor).  ``device`` says where every
  solve and every magnetic-field evaluation runs: the CUDA card unless
  the caller passes ``device='cpu'``.
- ``jvec``/the gradient's regridding adjoint do not need discretize: the
  edge-inner-product derivative and the volume-average adjoint are
  implemented natively (emg3d_tpu_torch.maps).
"""

import itertools
import os
import warnings
from copy import deepcopy
from pathlib import Path

import numpy as np

from emg3d_tpu_torch import (config, fields, io, maps, meshes, models,
                             utils)
from emg3d_tpu_torch.parallel import batch as _batch
from emg3d_tpu_torch.parallel import tasks as _tasks

__all__ = ['Simulation']


def __dir__():
    return __all__


@utils._known_class
class Simulation:
    """Forward modelling, misfit, and adjoint-state gradients of a survey.

    Mirrors the reference Simulation (emg3d/simulations.py:42-1748):
    gridding modes 'same'/'single'/'frequency'/'source'/'both'/'input'/
    'dict'; ``compute``/``misfit``/``gradient``/``jvec``/``jtvec``;
    file-based computation via ``file_dir``; (de)serialization.

    ``max_workers`` is kept for API parity; see
    :mod:`emg3d_tpu_torch.parallel.tasks` for the execution model.

    ``device`` (default None: the CUDA card; a host without one raises
    ``RuntimeError``) places every solve and every magnetic-field
    evaluation; pass ``device='cpu'`` to run on the CPU.  A ``'device'``
    or ``'dtype'`` entry of ``solver_opts`` is honoured too (the keyword
    wins over the entry).  Both are kept as strings, so that they
    survive serialization.
    """

    # Optional constructor settings stored verbatim as attributes.
    # 'parallel' selects the survey fan-out: 'task' (host loop over the
    # device solver; default) or 'batch' ((source, freq) pairs as a
    # leading task axis of one batched solve per grid; every solve of the
    # simulation goes through it).
    # 'shape_classes' (False | True | float max-growth factor) snaps the
    # per-task grids of the multi-grid gridding modes onto shared shape
    # classes (meshes.snap_shapes + pad_mesh_cells), as the JAX package
    # does to bound its compilation; here it only bounds the number of
    # distinct hierarchy shapes.
    _SIMPLE_KWARGS = {'parallel': 'task', 'verb': 0, 'name': None,
                      'info': None, 'receiver_interpolation': 'cubic',
                      'shape_classes': False}

    def __init__(self, survey, model, max_workers=4, gridding='single',
                 **kwargs):
        self.survey = survey
        self.max_workers = max_workers
        self.gridding = gridding
        for key, default in self._SIMPLE_KWARGS.items():
            setattr(self, key, kwargs.pop(key, default))

        self._init_solver_opts(kwargs.pop('solver_opts', {}),
                               kwargs.pop('device', None))
        self._init_progress_bars(kwargs.pop('tqdm_opts', {}))

        self._reset_task_caches(grids=True)
        self._forget_results()

        self.file_dir = kwargs.pop('file_dir', None)
        if self.file_dir:
            self.file_dir = os.path.abspath(self.file_dir)
            Path(self.file_dir).mkdir(exist_ok=True)

        self._set_model(model, kwargs)
        self._set_layered_opts(kwargs.pop('layered', False),
                               kwargs.pop('layered_opts', {}))
        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs)}.")

        if 'synthetic' not in self.survey.data.keys():
            self.survey.data['synthetic'] = self._nan_responses()

        # Warn early about MG-unfriendly shapes of user-fixed grids.
        if gridding == 'same':
            meshes.check_mesh(self.model.grid)
        elif gridding == 'input':
            meshes.check_mesh(self._grid_single)

    def _init_solver_opts(self, user_opts, device):
        """Solver options; the two tolerances are kept separately
        (reference simulations.py:270-279).  The device (and the working
        dtype, if given) ride in the options of every task, as strings.
        """
        self.solver_opts = {'verb': 1, 'log': -1, **user_opts,
                            'return_info': True}
        if device is None:
            device = self.solver_opts.get('device')
        self.device = str(config.resolve_device(device))
        self.solver_opts['device'] = self.device
        if self.solver_opts.get('dtype') is not None:
            self.solver_opts['dtype'] = config.dtype_name(
                self.solver_opts['dtype'])
        else:
            self.solver_opts.pop('dtype', None)
        self.tol_forward = self.solver_opts.get('tol', 1e-6)
        self.tol_gradient = self.solver_opts.pop(
            'tol_gradient', self.tol_forward)

    def _reset_task_caches(self, grids):
        """Fresh (source, frequency) caches; optionally also the grids."""
        blank = self._dict_initiate
        if grids:
            self._dict_grid = {k: dict(v) for k, v in blank.items()}
        self._dict_efield = {k: dict(v) for k, v in blank.items()}
        self._dict_efield_info = blank
        for extra in ('_dict_bfield', '_dict_bfield_info'):
            self.__dict__.pop(extra, None)

    def _forget_results(self):
        """Invalidate everything derived from solved fields."""
        self._computed = False
        self._misfit = None
        self._gradient = None

    def _nan_responses(self):
        """An all-NaN data array in the survey's (src, rec, freq) shape."""
        blank = np.full(self.survey.shape, np.nan + 1j * np.nan)
        return self.data.observed.copy(data=blank)

    def _init_progress_bars(self, tqdm_opts):
        if isinstance(tqdm_opts, bool):
            tqdm_opts = {'disable': not tqdm_opts}
        self._tqdm_opts = {
            'bar_format': '{desc} {bar} {n_fmt}/{total_fmt}  [{elapsed}]',
            **tqdm_opts,
        }

    def __repr__(self):
        def tag(obj):
            return f" «{obj.name}»" if obj.name else ""

        ns, nr, nf = self.survey.shape
        head = f":: {self.__class__.__name__}{tag(self)} ::\n"
        if self.info:
            head += f"{self.info}\n"
        body = "\n".join([
            f"- {self.survey.__class__.__name__}{tag(self.survey)}: "
            f"{ns} sources; {nr} receivers; {nf} frequencies",
            f"- {self.model!r}",
            f"- Gridding: {self._info_grids}",
        ])
        return head + "\n" + body

    # ----------------------------------------------------------------------
    # (De-)serialization.
    # ----------------------------------------------------------------------

    # Serialized configuration: (dict key, attribute) — the dict keys
    # double as constructor kwargs in from_dict (tol_gradient rides in
    # solver_opts; _input_sc2 is the private trailing-z-cells marker).
    _STATE_ATTRS = (
        ('max_workers', 'max_workers'), ('gridding', 'gridding'),
        ('parallel', 'parallel'), ('gridding_opts', 'gridding_opts'),
        ('solver_opts', 'solver_opts'), ('verb', 'verb'),
        ('name', 'name'), ('info', 'info'), ('tqdm_opts', '_tqdm_opts'),
        ('layered', 'layered'), ('layered_opts', 'layered_opts'),
        ('receiver_interpolation', 'receiver_interpolation'),
        ('tol_gradient', 'tol_gradient'), ('file_dir', 'file_dir'),
        ('shape_classes', 'shape_classes'), ('_input_sc2', '_input_sc2'),
        ('device', 'device'),
    )

    # The cached per-task state dictionaries (dict[source][freq]).
    _TASK_DICTS = ('_dict_grid', '_dict_efield', '_dict_efield_info',
                   '_dict_bfield', '_dict_bfield_info')

    def clean(self, what='computed'):
        """Remove computed data ('computed', 'keepresults', or 'all').

        Reference simulations.py:354-412.
        """
        if what not in ('computed', 'keepresults', 'all'):
            raise TypeError(f"Unrecognized `what`: {what}.")

        # All variants drop the fields; 'keepresults'/'all' also drop
        # the grids; 'computed'/'all' also drop the derived results.
        self._reset_task_caches(grids=what != 'computed')
        if self.file_dir:
            for spill in Path(self.file_dir).glob('[ebg]field_*.h5'):
                spill.unlink()

        if what != 'keepresults':
            self._forget_results()
            for key in {'residual', 'weights'} & set(self.data.keys()):
                del self.data[key]
            self.data['synthetic'] = self._nan_responses()

    def copy(self, what='computed'):
        """Return a copy of the Simulation."""
        return self.from_dict(self.to_dict(what, True))

    def to_dict(self, what='computed', copy=False):
        """Serialize to a dict; ``what`` ∈ {computed, results, all, plain}.

        Reference simulations.py:422-484.
        """
        what = self.__dict__.pop('_what_to_file', what)
        if what not in ('computed', 'results', 'all', 'plain'):
            raise TypeError(f"Unrecognized `what`: {what}.")

        self.solver_opts['tol'] = self.tol_forward
        out = {'__class__': self.__class__.__name__,
               'survey': self.survey.to_dict(),
               'model': self.model.to_dict()}
        out.update((key, getattr(self, attr))
                   for key, attr in self._STATE_ATTRS)

        if what == 'plain':
            stored = out['survey']['data']
            for key in {'synthetic', 'residual', 'weights'} & set(stored):
                del stored[key]
        else:
            out.update(gradient=self._gradient, misfit=self._misfit,
                       computed=self._computed)
            if what != 'results':
                out.update((name, getattr(self, name))
                           for name in self._TASK_DICTS
                           if hasattr(self, name))

        return deepcopy(out) if copy else out

    @classmethod
    def from_dict(cls, inp):
        """Create a Simulation from a dict (reference simulations.py:485)."""
        from emg3d_tpu_torch import surveys

        inp = {k: v for k, v in inp.items() if k != '__class__'}

        # Mandatory parts.
        survey = inp.pop('survey')
        if isinstance(survey, dict):
            survey = surveys.Survey.from_dict(survey)
        model = inp.pop('model')
        if isinstance(model, dict):
            model = models.Model.from_dict(model)

        # Optional stored state.
        computed = inp.pop('computed', False)
        misfit = inp.pop('misfit', None)
        gradient = inp.pop('gradient', None)
        stored = {name: inp.pop(name) for name in cls._TASK_DICTS
                  if name in inp}

        # tol_gradient travels inside solver_opts (popped in __init__).
        if 'tol_gradient' in inp:
            inp.setdefault('solver_opts', {})
            inp['solver_opts']['tol_gradient'] = inp.pop('tol_gradient')

        # gridding_opts go back through the constructor.
        gridding = inp.pop('gridding', 'single')
        gridding_opts = inp.pop('gridding_opts', {})
        if gridding in ('dict', 'input'):
            # Deserialize grids.
            if gridding == 'dict' and isinstance(gridding_opts, dict):
                gridding_opts = {
                    src: {f: (meshes.TensorMesh.from_dict(g)
                              if isinstance(g, dict) else g)
                          for f, g in fdict.items()}
                    for src, fdict in gridding_opts.items()}
            elif gridding == 'input' and isinstance(gridding_opts, dict):
                gridding_opts = meshes.TensorMesh.from_dict(gridding_opts)

        sim = cls(survey=survey, model=model, gridding=gridding,
                  gridding_opts=gridding_opts, **inp)

        # Restore stored state.  Grids/fields arrive as plain dicts
        # from io and need reviving; info dicts, None placeholders and
        # file_dir path strings pass through untouched.
        for name, by_task in stored.items():
            revive = (meshes.TensorMesh if 'grid' in name
                      else None if 'info' in name else fields.Field)
            setattr(sim, name, {
                src: {f: (revive.from_dict(v) if revive is not None
                          and isinstance(v, dict) else v)
                      for f, v in fdict.items()}
                for src, fdict in by_task.items()})

        sim._computed = computed
        sim._misfit = misfit
        sim._gradient = gradient

        # Synthetic responses exist => mark computed.
        if np.isfinite(np.asarray(sim.data.synthetic)).any():
            sim._computed = True

        return sim

    def to_file(self, fname, what='computed', name='simulation', **kwargs):
        """Store the Simulation to a file (reference simulations.py:547).

        ``what`` is smuggled to ``to_dict`` through a transient
        attribute because io.save serializes via to_dict without
        arguments.
        """
        self._what_to_file = what
        return io.save(fname, **{**kwargs, name: self})

    @classmethod
    def from_file(cls, fname, name='simulation', **kwargs):
        """Load a Simulation from a file (reference simulations.py:588)."""
        loaded = io.load(fname, **kwargs)
        if kwargs.get('verb', 0) < 0:      # (data, info-string) form.
            return loaded[0][name], loaded[1]
        return loaded[name]

    # ----------------------------------------------------------------------
    # Grids, models, fields.
    # ----------------------------------------------------------------------

    @property
    def data(self):
        """Shortcut to survey.data."""
        return self.survey.data

    def get_grid(self, source, frequency):
        """Computational grid for (source, frequency).

        Gridding modes per reference simulations.py:624-697.  Every
        mode reduces to *which tasks share a grid*: 'same' shares the
        model grid, 'single'/'input' share one constructed grid,
        'frequency'/'source' share per-key, 'both' shares nothing.
        The shared grids live in one cache keyed by the sharing unit.
        """
        freq = self._freq_inp2key(frequency)
        if self._dict_grid[source][freq] is None:
            self._dict_grid[source][freq] = self._build_grid(source, freq)
        return self._dict_grid[source][freq]

    # gridding mode -> (cache-key fields, construct_mesh extras)
    _GRID_SHARING = {
        'frequency': ('f', ('frequency',)),
        'source': ('s', ('center',)),
        'both': ('sf', ('frequency', 'center')),
        'single': ('', ()),
    }

    def _build_grid(self, source, freq):
        if self.gridding == 'same':
            return self.model.grid
        if self.gridding == 'input':    # user-provided, _set_model
            return self._grid_single

        key_fields, extras = self._GRID_SHARING.get(
            self.gridding, self._GRID_SHARING['single'])
        key = (source if 's' in key_fields else None,
               freq if 'f' in key_fields else None)

        cache = getattr(self, '_shared_grids', None)
        if cache is None:
            cache = self._shared_grids = {}
        if key not in cache:
            if self.shape_classes and key_fields:
                self._grid_all_snapped(key_fields, extras)
            else:
                cache[key] = meshes.construct_mesh(
                    **self._construct_inp(extras, source, freq))
        return cache[key]

    def _construct_inp(self, extras, source, freq):
        inp = dict(self.gridding_opts)
        if 'frequency' in extras:
            inp['frequency'] = self.survey.frequencies[freq]
        if 'center' in extras:
            inp['center'] = self.survey.sources[source].center
        return inp

    def _grid_all_snapped(self, key_fields, extras):
        """Grid every sharing key eagerly, then snap shapes to classes.

        Cold-start control for the multi-grid gridding modes
        ('frequency'/'source'/'both'): executables are compiled per grid
        SHAPE (cell widths are traced values), so padding the
        automatically-constructed grids onto shared shape classes
        (``meshes.snap_shapes``; growth bound ``shape_classes`` when
        given as a float, default 1.35) compiles O(classes) multigrid
        hierarchies instead of one per distinct grid.  Padding only
        grows the buffer outward (``meshes.pad_mesh_cells``), so the
        survey domain and its discretization are unchanged.
        """
        srcs = list(self.survey.sources) if 's' in key_fields else [None]
        freqs = (list(self.survey.frequencies) if 'f' in key_fields
                 else [None])
        raw = {(s, f): meshes.construct_mesh(
                   **self._construct_inp(extras, s, f))
               for s in srcs for f in freqs}
        growth = (1.35 if self.shape_classes is True
                  else float(self.shape_classes))
        classes = meshes.snap_shapes(
            [g.shape_cells for g in raw.values()], max_growth=growth)
        for k, g in raw.items():
            target = classes[g.shape_cells]
            self._shared_grids[k] = (
                g if target == g.shape_cells
                else meshes.pad_mesh_cells(g, target))

    def get_model(self, source, frequency):
        """Model interpolated to the task grid."""
        return self.model.interpolate_to_grid(
            self.get_grid(source, frequency))

    def get_efield(self, source, frequency):
        """Electric field for (source, frequency); computes if missing."""
        return self._dict_get('efield', source, frequency,
                              solve_if_missing=True)

    def get_hfield(self, source, frequency):
        """Magnetic field for (source, frequency)."""
        efield = self.get_efield(source, frequency)
        return fields.get_magnetic_field(
            self.get_model(source, frequency), efield, device=self.device)

    def get_efield_info(self, source, frequency):
        """Solver info of the (source, frequency) computation."""
        return self._dict_get('efield_info', source, frequency)

    def _dict_get(self, which, source, frequency, solve_if_missing=False):
        """Cached per-task value; optionally triggers the missing solve.

        Transparent to ``file_dir`` spilling: a cached str is an h5
        path and is read back on access.
        """
        freq = self._freq_inp2key(frequency)
        cache = getattr(self, f"_dict_{which}")
        if cache[source][freq] is None and solve_if_missing:
            self.compute(source=source, frequency=freq)
        part = 'info' if which.endswith('info') else 'efield'
        return self._load(cache[source][freq], part)

    def _load(self, value, what):
        """Resolve a cached value, reading the h5 spill if file-based."""
        if isinstance(value, str) and self.file_dir:
            return io.load(value, verb=0)[what]
        return value

    def _data_or_file(self, what, source, frequency, data):
        """Return data, or write it to an h5 file and return the name."""
        if self.file_dir:
            fname = os.path.join(
                self.file_dir, f"{what}_{source}_{frequency}.h5")
            io.save(fname, data=data, verb=0)
            return fname
        return data

    def _get_responses(self, source, frequency, efield=None):
        """Electric/magnetic responses at the receiver locations.

        Reference simulations.py:759-793.  The two receiver families
        sample different fields: electric receivers the efield itself,
        magnetic ones its curl (H via Faraday) — hence the deferred
        field factory per group.
        """
        if efield is None:
            efield = self._dict_get('efield', source, frequency)

        idx_e, idx_m = self.survey._irec_types
        coords_e, coords_m = self.survey._rec_types_coord(source)
        groups = (
            (idx_e, coords_e, lambda: efield),
            (idx_m, coords_m, lambda: fields.get_magnetic_field(
                self.get_model(source, frequency), efield,
                device=self.device)),
        )

        resp = np.zeros_like(self.data.synthetic.loc[source, :, frequency])
        for idx, coords, field_of in groups:
            if idx.size:
                resp[idx] = field_of().get_receiver(
                    receiver=coords,
                    method=self.receiver_interpolation)
        return resp

    # ----------------------------------------------------------------------
    # Computation.
    # ----------------------------------------------------------------------

    def compute(self, observed=False, **kwargs):
        """Compute efields for all (source, frequency) pairs.

        Reference simulations.py:795-833.  ``observed=True`` stores the
        synthetic responses as observed and adds noise (if configured).
        """
        task = (kwargs.pop('source', None), kwargs.pop('frequency', None))
        if self.layered:
            if any(task):
                raise NotImplementedError("No fields if `layered` is used.")
            self._compute_1d()
        else:
            self._compute([task])

        if observed:
            self.data['observed'] = self.data['synthetic'].copy()
            if kwargs.pop('add_noise', True):
                self.survey.add_noise(**kwargs)
        elif task == (None, None):
            self._computed = True

    def _solve_tasks(self, kind, srcfreq, payload, desc, tol):
        """Fan (source, frequency) solves out through the task engine.

        ``payload(src, freq)`` supplies the per-task solve inputs; the
        shared fields (model, solver options with ``tol``) are merged
        here and each task is spilled to file when ``file_dir`` is set.
        Returns the list of (field, info) results.
        """
        def pack(sf):
            src, freq = sf
            data = {'model': self.model,
                    'solver_opts': self.solver_opts,
                    **payload(src, freq)}
            data['solver_opts']['tol'] = tol
            return self._data_or_file(kind, src, freq, data)

        return _tasks.process_map(
            _tasks.solve, [pack(sf) for sf in srcfreq],
            max_workers=self.max_workers,
            **{'desc': desc, **self._tqdm_opts})

    def _compute(self, srcfreq):
        """Solve the electric fields (reference simulations.py:835-880)."""
        if not srcfreq[0][0]:
            srcfreq = self._srcfreq
        if self.parallel == 'batch':
            return self._compute_batch(srcfreq)

        def efield_payload(src, freq):
            return {
                'grid': self.get_grid(src, freq),
                'source': self.survey.sources[src],
                'frequency': self.survey.frequencies[freq],
                'efield': self._dict_get('efield', src, freq),
            }

        out = self._solve_tasks('efield', srcfreq, efield_payload,
                                'Compute efields', self.tol_forward)

        for (src, freq), (efield, einfo) in zip(srcfreq, out):
            self._dict_efield[src][freq] = efield
            self._dict_efield_info[src][freq] = einfo
            self.data['synthetic'].loc[src, :, freq] = \
                self._get_responses(src, freq)

        self.print_solver_info('efield', verb=self.verb)

    def _batch_setup(self, tol):
        """The solver options of a batched solve: those the batch engine
        takes, with the device, the working dtype and ``tol``."""
        sopts = {k: v for k, v in self.solver_opts.items()
                 if k in ('tol', 'maxit', 'cycle', 'sslsolver',
                          'semicoarsening', 'linerelaxation', 'clevel',
                          'nu_init', 'nu_pre', 'nu_coarse', 'nu_post',
                          'verb', 'device', 'dtype')}
        sopts['tol'] = tol
        return sopts

    def _batch_groups(self, srcfreq):
        """Group (source, frequency) pairs by their computational grid.

        The batch engine solves one grid per call; any gridding mode
        parallelizes by batching each grid-sharing unit separately
        (reference behavior: the process pool parallelizes EVERY mode,
        _multiprocessing.py:33-69).  'same' yields one group;
        'frequency'/'source'/'single'/'input' one group per shared
        grid; 'both'/'dict' degenerate to per-task groups.  ``get_grid``
        caches one grid OBJECT per sharing unit, so identity-grouping
        is exact.  Returns ``[(pairs, model-on-that-grid), ...]``.
        """
        groups = {}
        for src, freq in srcfreq:
            grid = self.get_grid(src, freq)
            groups.setdefault(id(grid), (grid, []))[1].append((src, freq))
        out = []
        for grid, pairs in groups.values():
            gmodel = (self.model if grid is self.model.grid
                      else self.get_model(*pairs[0]))
            out.append((pairs, gmodel))
        return out

    def _store_batch_result(self, kind, srcfreq, fields_out, info):
        """Unpack a batch solve into the per-task caches.

        Mirrors what the task engine stores: its info-dict keys, and with
        ``file_dir`` the field and info in the file the task engine's
        worker writes (``tasks._task_output_path``).
        """
        dict_field = getattr(self, f'_dict_{kind}')
        dict_info = getattr(self, f'_dict_{kind}_info')
        for i, (src, freq) in enumerate(srcfreq):
            task_info = {
                'exit': int(info['exit_messages'][i] != 'CONVERGED'),
                'exit_message': info['exit_messages'][i],
                'abs_error': float(info['abs_error'][i]),
                'rel_error': float(info['rel_error'][i]),
                'it_mg': info['it_mg'],
                'it_ssl': info['it_ssl'],
                'tol': info['tol'],
                'runtime': info['runtime'],
            }
            field = fields_out[i]
            if self.file_dir:
                fname = _tasks._task_output_path(os.path.join(
                    self.file_dir, f"{kind}_{src}_{freq}.h5"))
                io.save(fname, efield=field, info=task_info, verb=0)
                field = task_info = fname
            dict_field[src][freq] = field
            dict_info[src][freq] = task_info

    def _compute_batch(self, srcfreq):
        """The pairs as one batched solve per grid-sharing group
        (:func:`emg3d_tpu_torch.parallel.batch.solve_batch`)."""
        sopts = self._batch_setup(self.tol_forward)

        for pairs, gmodel in self._batch_groups(srcfreq):
            sources = [self.survey.sources[src] for src, _ in pairs]
            freqs = [self.survey.frequencies[f] for _, f in pairs]
            guesses = [self._dict_get('efield', src, freq)
                       for src, freq in pairs]

            efields, info = _batch.solve_batch(
                gmodel, sources, freqs, efields=guesses, **sopts)
            self._store_batch_result('efield', pairs, efields, info)

        for src, freq in srcfreq:
            self.data['synthetic'].loc[src, :, freq] = \
                self._get_responses(src, freq)

        self.print_solver_info('efield', verb=self.verb)

    def _compute_1d(self, gradient=False):
        """Layered (1-D) modelling via the native engine.

        Mirror of reference simulations.py:882-941, with the bundled
        transmission-line/Hankel-DLF engine (emg3d_tpu_torch.layered)
        replacing empymod.
        """
        has_data = np.isfinite(np.asarray(self.data.observed)).any()

        def per_source(isrc, source):
            task = {
                'model': self.model,
                'src': self.survey.sources[source],
                'receivers': self.survey.receivers,
                'frequencies': self.survey.frequencies,
                'layered_opts': self.layered_opts,
                'gradient': gradient,
                'observed': (np.asarray(self.data.observed)[isrc]
                             if has_data else None),
            }
            if gradient:
                task['residual'] = np.asarray(self.data.residual)[isrc]
                task['weights'] = np.asarray(self.data.weights)[isrc]
            return task

        source_names = list(self.survey.sources)
        out = _tasks.process_map(
            _tasks.layered,
            [per_source(i, s) for i, s in enumerate(source_names)],
            max_workers=self.max_workers,
            **{'desc': 'Compute layered', **self._tqdm_opts})

        if gradient:
            return np.sum(out, axis=0)

        for src, responses in zip(source_names, out):
            self.data['synthetic'].loc[src, :, :] = responses

    # ----------------------------------------------------------------------
    # Optimization: misfit, gradient, jvec, jtvec.
    # ----------------------------------------------------------------------

    @property
    def misfit(self):
        """Weighted l2 data misfit φ = Σ w|r|²/2.

        Reference simulations.py:1096-1191; NaN entries (no data) are
        excluded from the sum.
        """
        if self._misfit is None:
            # Validate the weights BEFORE the (expensive) forward
            # computes: a missing standard deviation should fail fast,
            # not after minutes of solves.
            self._ensure_weights()
            if not self._computed:
                self.compute()

            self.data['residual'] = (
                self.data.synthetic - self.data.observed)
            r = np.asarray(self.data.residual)
            w = np.asarray(self.data.weights)
            self._misfit = 0.5 * float(
                np.nansum(w * (r.real**2 + r.imag**2)))

        return self._misfit

    def _ensure_weights(self):
        """Derive the data weights 1/std² on first use."""
        if 'weights' in self.data.keys():
            return
        std = self.survey.standard_deviation
        if std is None:
            raise ValueError(
                "The misfit needs data weights: set `noise_floor` "
                "and/or `relative_error` (> 0) on the survey so the "
                "`standard_deviation` can be derived, or assign "
                "`survey.standard_deviation` directly (same shape as "
                "the data).")
        self.data['weights'] = std ** -2

    @property
    def gradient(self):
        """Adjoint-state gradient (reference simulations.py:943-1094).

        Shape: (nx, ny, nz) isotropic; (2, ...) HTI/VTI; (3, ...)
        triaxial.
        """
        if self._gradient is None:
            _ = self.misfit  # Ensures fields are computed.

            if self.layered:
                gradient = self._compute_1d(gradient=True)
            else:
                if self.receiver_interpolation == 'cubic':
                    warnings.warn(
                        "emg3d: Receiver responses were obtained with "
                        "cubic interpolation. This will not yield the "
                        "exact gradient. Change "
                        "`receiver_interpolation='linear'` in the call "
                        "to Simulation().", UserWarning)

                non_unity = {
                    'el. permittivity': self.model.epsilon_r,
                    'magn. permeability': self.model.mu_r,
                }
                for what, values in non_unity.items():
                    if values is not None and not np.allclose(values, 1.0):
                        raise NotImplementedError(
                            f"Gradient not implemented for {what}.")

                self._bcompute()

                gradient = np.zeros((3, *self.model.shape), order='F')

                for src, freq in self._srcfreq:
                    efield = self._dict_get('efield', src, freq)
                    bfield = self._dict_get('bfield', src, freq)

                    # λ̄ S' E: multiply back- and forward fields.
                    gfield = fields.Field(
                        grid=efield.grid,
                        data=np.real(
                            bfield.field * efield.smu0 * efield.field))

                    shape = gfield.grid.shape_cells
                    grad = np.zeros((3, *shape), order='F')
                    cell_volumes = gfield.grid.cell_volumes
                    maps.interp_edges_to_vol_averages(
                        ex=gfield.fx, ey=gfield.fy, ez=gfield.fz,
                        volumes=cell_volumes.reshape(shape, order='F'),
                        ox=grad[0, ...], oy=grad[1, ...],
                        oz=grad[2, ...])

                    if self.model.grid != gfield.grid:
                        maps.interp_volume_average_adj(
                            oval=gradient, ogrid=self.model.grid,
                            nval=grad, ngrid=gfield.grid)
                    else:
                        gradient += grad

            self._gradient = self._merge_gradient_axes(gradient)

        return self._gradient

    def _merge_gradient_axes(self, gradient):
        """Per-direction edge gradient -> model-parameter gradient.

        Directions the anisotropy case does not parameterize fold into
        the x slot; each kept slot then goes through the property-map
        chain rule (reference simulations.py:1071-1092).
        """
        # case -> (kept slots, (slot, property) chain-rule pairs)
        case = self.model.case
        kept = {'isotropic': [0], 'HTI': [0, 1], 'VTI': [0, 2],
                'triaxial': [0, 1, 2]}[case]
        props = {0: self.model.property_x, 1: self.model.property_y,
                 2: self.model.property_z}

        for axis in (1, 2):
            if axis not in kept:
                gradient[0, ...] += gradient[axis, ...]
        # x last: folding must happen before its chain rule.
        for axis in sorted(kept, reverse=True):
            self.model.map.derivative_chain(
                gradient[axis, ...], props[axis])

        return gradient[kept, ..., :self._input_sc2].squeeze()

    def _bcompute(self):
        """Back-propagate the residual fields (simulations.py:1193-1233).

        In ``parallel='batch'`` mode the adjoint sources stack like
        forward source fields: one batched solve per grid-sharing group.
        """
        for cache in ('_dict_bfield', '_dict_bfield_info'):
            self.__dict__.setdefault(cache, self._dict_initiate)

        if self.parallel == 'batch':
            sopts = self._batch_setup(self.tol_gradient)
            for pairs, gmodel in self._batch_groups(self._srcfreq):
                rfields = [self._get_rfield(src, freq)
                           for src, freq in pairs]
                guesses = [self._dict_get('bfield', src, freq)
                           for src, freq in pairs]
                bfields, info = _batch.solve_batch_fields(
                    gmodel, rfields, efields=guesses, **sopts)
                self._store_batch_result('bfield', pairs, bfields, info)
        else:
            def bfield_payload(src, freq):
                return {
                    'sfield': self._get_rfield(src, freq),
                    'efield': self._dict_get('bfield', src, freq),
                }

            out = self._solve_tasks('bfield', self._srcfreq,
                                    bfield_payload, 'Back-propagate',
                                    self.tol_gradient)

            for (src, freq), (bfield, binfo) in zip(self._srcfreq, out):
                self._dict_bfield[src][freq] = bfield
                self._dict_bfield_info[src][freq] = binfo

        self.print_solver_info('bfield', verb=self.verb)

    def _get_rfield(self, source, frequency):
        """Adjoint (residual) source field (simulations.py:1235-1268)."""
        freq = self.survey.frequencies[frequency]

        grid = self.get_grid(source, frequency)
        residual = self.data.residual.loc[source, :, frequency]
        weight = self.data.weights.loc[source, :, frequency]

        rfield = fields.Field(grid, frequency=freq)

        # Weighted residual, normalized by -smu0, conjugated.
        strength = np.conj(residual * weight / -rfield.smu0)

        for i, rec in enumerate(self.survey.receivers.values()):
            if np.isnan(residual[i]):
                continue
            coords = rec.coordinates_abs(self.survey.sources[source])
            src = rec._adjoint_source(coords, strength=strength[i])
            rfield.field = (
                rfield.field
                + src.get_field(grid=grid, frequency=freq).field)

        return rfield

    def jvec(self, vector):
        """J v = P A⁻¹ G v: sensitivity times model vector.

        Reference simulations.py:1270-1397 (there via discretize; here
        via the native edge-inner-product derivative in
        emg3d_tpu_torch.maps).
        """
        if self.layered:
            raise NotImplementedError(
                "`jvec` is not implemented for `layered`.")

        _ = self.misfit  # Ensures fields are computed.

        vector = np.array(vector, copy=True)
        if vector.ndim == 3:
            vector = vector[None]

        # The vector's leading slots hold one component per
        # parameterized property of the anisotropy case; each goes
        # through the property-map chain rule in place.
        m = self.model
        case_props = {
            'isotropic': (m.property_x,),
            'HTI': (m.property_x, m.property_y),
            'VTI': (m.property_x, m.property_z),
            'triaxial': (m.property_x, m.property_y, m.property_z),
        }
        for slot, prop in enumerate(case_props[m.case]):
            m.map.derivative_chain(vector[slot], prop)

        iopts = {'method': 'volume', 'extrapolate': True,
                 'log': False, 'grid': self.model.grid}

        # Map the per-axis model-space vectors onto the σx/σy/σz slots
        # of the edge inner product for each anisotropy case.
        _SLOTS = {'isotropic': (0, 0, 0), 'HTI': (0, 1, 0),
                  'VTI': (0, 0, 1), 'triaxial': (0, 1, 2)}

        def gfield_source(src, freq):
            efield = self._dict_get('efield', src, freq)
            on_task_grid = [
                maps.interpolate(values=v, xi=efield.grid, **iopts)
                for v in vector]
            cvec = tuple(on_task_grid[i]
                         for i in _SLOTS[self.model.case])
            gvec = maps.edge_product_deriv_times_vector(efield, cvec)
            return fields.Field(
                grid=efield.grid, data=-efield.smu0 * gvec,
                frequency=efield.frequency)

        if 'jvec' not in self.data.keys():
            self.data['jvec'] = self._nan_responses()

        if self.parallel == 'batch':
            # Sensitivity sources batch like forward sources: one batched
            # solve per grid-sharing group.
            sopts = self._batch_setup(self.tol_gradient)
            for pairs, gmodel in self._batch_groups(self._srcfreq):
                gsrcs = [gfield_source(src, freq) for src, freq in pairs]
                gfields, _ = _batch.solve_batch_fields(gmodel, gsrcs,
                                                       **sopts)
                for (src, freq), gfield in zip(pairs, gfields):
                    self.data['jvec'].loc[src, :, freq] = \
                        self._get_responses(src, freq, gfield)
            return self.data['jvec'].data

        def gfield_payload(src, freq):
            return {'sfield': gfield_source(src, freq), 'efield': None}

        out = self._solve_tasks('gfield', self._srcfreq, gfield_payload,
                                'Compute jvec', self.tol_gradient)

        for (src, freq), result in zip(self._srcfreq, out):
            gfield = self._load(result[0], 'efield')
            self.data['jvec'].loc[src, :, freq] = \
                self._get_responses(src, freq, gfield)

        return self.data['jvec'].data

    def jtvec(self, vector):
        """Jᴴ v: adjoint sensitivity (equals gradient for v=w·r).

        Reference simulations.py:1399-1444.
        """
        _ = self.misfit  # Ensure weights/residual exist.

        # Implant v/w as the "residual" so the adjoint solve
        # back-propagates v instead of w·r; then rebuild the gradient.
        with np.errstate(invalid='ignore'):
            self.data.residual[...] = (
                np.asarray(vector) / np.asarray(self.data.weights))

        self._gradient = None
        self.__dict__.pop('_dict_bfield', None)
        self.__dict__.pop('_dict_bfield_info', None)
        return self.gradient

    # ----------------------------------------------------------------------
    # Utils.
    # ----------------------------------------------------------------------

    @property
    def _dict_initiate(self):
        """Nested dict[source][freq] = None."""
        return {src: {freq: None for freq in self.survey.frequencies}
                for src in self.survey.sources.keys()}

    @property
    def _srcfreq(self):
        """List of all (source, frequency) key pairs."""
        if getattr(self, '__srcfreq', None) is None:
            self.__srcfreq = list(itertools.product(
                self.survey.sources.keys(),
                self.survey.frequencies.keys()))
        return self.__srcfreq

    def _freq_inp2key(self, frequency):
        """Accept a frequency key or value; return the key."""
        if not isinstance(frequency, str):
            if not hasattr(self, '__freq_inp2key'):
                self.__freq_inp2key = {
                    float(v): k for k, v in
                    self.survey.frequencies.items()}
            frequency = self.__freq_inp2key[float(frequency)]
        return frequency

    @property
    def _info_grids(self):
        """One-line info about the used grid(s)."""
        if self.gridding == 'same':
            srcfreq = self._srcfreq[0]
            grid = self.get_grid(*srcfreq)
            return (f"Same grid as model: {grid.shape_cells[0]} x "
                    f"{grid.shape_cells[1]} x {grid.shape_cells[2]}")
        return f"{self.gridding}"

    def print_grid_info(self, verb=1, return_info=False):
        """Print (or return) information about the computational grids."""
        out = ""
        printed = set()
        for src, freq in self._srcfreq:
            grid = self.get_grid(src, freq)
            if id(grid) in printed:
                continue
            printed.add(id(grid))
            out += (f"= Grid for [{src}, {freq}] and all that share it =\n"
                    f"{grid!r}\n")
        if return_info:
            return out
        if verb > 0:
            print(out)

    def print_solver_info(self, field='efield', verb=1, return_info=False):
        """Print solver exit messages (simulations.py:1574-1614)."""
        if verb < 0:
            return None if not return_info else ""

        info = getattr(self, f"_dict_{field}_info", {})
        out = ""
        for src, freq in self._srcfreq:
            cinfo = info[src][freq]
            cinfo = self._load(cinfo, 'info')
            if cinfo is None:
                continue
            exit_ = cinfo.get('exit', 0)
            if verb > 0 or exit_ != 0:
                out += (f"= Solver settings and info for {src} / {freq} "
                        f"(exit: {exit_}) =\n")
                out += f"   > {cinfo.get('exit_message', '')}\n"
        if return_info:
            return out
        if out:
            print(out)

    # ----------------------------------------------------------------------
    # Model / gridding / layered setup.
    # ----------------------------------------------------------------------

    def _set_model(self, model, kwargs):
        """Set self.model and self.gridding_opts (simulations.py:1616).

        What ``gridding_opts`` means depends on the mode: 'dict' — the
        full per-task grid table; 'input' — one ready-made grid;
        'same' — nothing (forbidden); all constructed modes — hints
        for the automatic gridding search, completed here.
        """
        self._input_sc2 = kwargs.pop('_input_sc2', model.shape[2])
        opts = kwargs.pop('gridding_opts', {})

        if self.gridding == 'dict':
            self._dict_grid = opts
        elif self.gridding == 'input':
            self._grid_single = opts
        elif self.gridding == 'same':
            if opts:
                raise TypeError(
                    "`gridding_opts` is not permitted if "
                    "`gridding='same'`.")
        else:
            opts = dict(opts)
            model = self._apply_expand(model, opts)
            opts = meshes.estimate_gridding_opts(
                opts, model, self.survey, self._input_sc2)

        self.gridding_opts = opts
        self.model = model

    @staticmethod
    def _apply_expand(model, opts):
        """Deprecated ``expand``: grow the model up to the sea surface."""
        expand = opts.pop('expand', None)
        if expand is None:
            return model
        warnings.warn(
            "emg3d: `expand` is deprecated; a property-complete "
            "model has to be provided.", FutureWarning)
        if 'seasurface' not in opts:
            raise KeyError(
                "`gridding_opts['seasurface']` is required when "
                "`expand` is given.")
        return models.expand_grid_model(model, expand, opts['seasurface'])

    @property
    def layered(self):
        """If True, use layered (1-D) computations.

        Settable: assigning re-derives ``layered_opts`` (reference
        simulations.py:1669-1676).
        """
        return self._layered

    @layered.setter
    def layered(self, layered):
        self._set_layered_opts(layered, getattr(self, 'layered_opts',
                                                {}))

    def _set_layered_opts(self, layered, layered_opts):
        """Set self.layered / self.layered_opts (simulations.py:1678).

        Defaults the extraction method to 'cylinder' with a
        one-skin-depth radius (at the lowest survey frequency and the
        minimum bottom-boundary conductivity).
        """
        self._layered = bool(layered)

        if not self.layered:
            self.layered_opts = dict(layered_opts or {})
            return

        for sr in (list(self.survey.sources.values())
                   + list(self.survey.receivers.values())):
            name = sr.__class__.__name__
            if 'Point' not in name and 'Dipole' not in name:
                raise ValueError(
                    "Layered: Only Points and Dipoles supported, "
                    f"provided: {sr}!")

        if self.model.case not in ['isotropic', 'VTI']:
            raise NotImplementedError(
                f"Layered compute not implemented for "
                f"{self.model.case} case.")

        layered_opts = deepcopy(dict(layered_opts or {}))
        layered_opts.setdefault('method', 'cylinder')

        if layered_opts['method'] in ['prism', 'cylinder']:
            ellipse = layered_opts.get('ellipse', {})
            if ellipse.get('radius') is None:
                ellipse['radius'] = self._default_selection_radius()
            ellipse.setdefault('factor', 1.2)
            ellipse.setdefault('minor', 0.8)
            layered_opts['ellipse'] = ellipse

        self.layered_opts = layered_opts

    def _default_selection_radius(self):
        """One skin depth at the lowest survey frequency.

        The conductivity is taken from the gridding properties (the
        bottom-boundary entry) when available, else from the least
        conductive cell of the model's deepest layer.
        """
        try:
            prop = np.atleast_1d(self.gridding_opts['properties'])
            pmap = getattr(maps,
                           'Map' + self.gridding_opts['mapping'])()
            cond = pmap.backward(prop[-1 if prop.size < 3 else -2])
        except (KeyError, TypeError):
            bottom = self.model.property_x[:, :, 0]
            cond = np.min(self.model.map.backward(bottom))
        freq = min(self.survey.frequencies.values())
        return meshes.skin_depth(freq, cond)
