"""Per-(source, frequency) task execution for Simulation.

Port of ``emg3d_tpu.parallel.tasks``.  The reference fans survey tasks
out to a ``ProcessPoolExecutor`` (emg3d/_multiprocessing.py:33-69),
pickling one dict per task.  Here the card is the compute resource, not
host processes: tasks run as a host-driven loop over the device solver,
one solve on the device at a time.  Where a solve runs is part of each
task's solver options (``device``, ``dtype``), as for
:func:`emg3d_tpu_torch.solver.solve`.

``process_map``/``solve`` keep the reference's worker contract
(_multiprocessing.py:33-153) so the Simulation layer and file-based
(h5-spill) computations behave identically.
"""

from emg3d_tpu_torch import io, solver, tracing

__all__ = ['process_map', 'solve', 'layered']


def process_map(fn, fn_inputs, max_workers=4, **kwargs):
    """Apply fn to each input; returns the list of results.

    Drop-in for the reference's process_map (_multiprocessing.py:33-69).
    ``max_workers`` is accepted for API parity but tasks are dispatched
    sequentially to the device: its kernels already use the whole card,
    so host-side process/thread pools only add pickle overhead.
    An optional tqdm progress bar mirrors the reference's UX.
    """
    process_map.count += 1

    tqdm_opts = {k: kwargs[k] for k in ('desc', 'bar_format', 'disable')
                 if k in kwargs}

    try:
        from tqdm.auto import tqdm
        iterator = tqdm(fn_inputs, **tqdm_opts)
    except ImportError:
        iterator = fn_inputs

    return [fn(inp) for inp in iterator]


process_map.count = 0


def _task_output_path(path):
    """Sibling output file for an h5-spill task: ``<stem>_out.<ext>``
    (the name the Simulation layer looks for; reference worker file
    convention, _multiprocessing.py:112-153)."""
    import pathlib

    p = pathlib.PurePath(path)
    return str(p.with_name(p.stem + '_out' + p.suffix))


def solve(inp):
    """Solve one task; keeps the reference worker's dict contract.

    ``inp`` is either a task dict or the path of an h5 file holding one
    under ``'data'`` (file-based / h5-spill computation).  Two task
    shapes exist (reference _multiprocessing.py:72-153):

    - ``{model, sfield, efield, solver_opts}`` — a prepared source
      field, solved on its own grid via :func:`solver.solve`;
    - ``{model, grid, source, frequency, efield, solver_opts}`` — a
      source definition, via :func:`solver.solve_source`.

    The model is interpolated onto the task grid first.  Returns
    ``(efield, info)``, or ``(out_path, out_path)`` in file mode with
    the results saved next to the input.
    """
    path = inp if isinstance(inp, str) else None
    task = io.load(path, verb=0)['data'] if path else inp

    if 'sfield' in task:
        grid = task['sfield'].grid
        run, how = solver.solve, {'sfield': task['sfield']}
    else:
        grid = task['grid']
        run, how = solver.solve_source, {'source': task['source'],
                                         'frequency': task['frequency']}

    # The worker always needs the info dict back, whatever the task's
    # own solver options say.
    opts = {**task['solver_opts'], 'return_info': True,
            'always_return': True}
    with tracing.span('emg3d.sim.model'):
        model = task['model'].interpolate_to_grid(grid)
        # A model already on the task's grid is returned as it is.
        tracing.count('sim_models', int(model is not task['model']))
    efield, info = run(model=model, efield=task['efield'], **how, **opts)

    if path:
        out = _task_output_path(path)
        io.save(out, efield=efield, info=info, verb=0)
        return out, out
    return efield, info


def layered(inp):
    """Layered (1-D) responses or FD gradient for one source.

    Native mirror of the reference's empymod worker
    (emg3d/_multiprocessing.py:156-463), built on the bundled layered
    engine (:mod:`emg3d_tpu_torch.layered`).  Input dict keys: model, src,
    receivers, frequencies, observed, layered_opts, gradient
    (+ weights/residual when gradient=True).

    Returns (nrec, nfreq) responses, or a (3, nx, ny, nz) gradient.
    """
    import numpy as np

    model = inp['model']
    want_grad = inp['gradient']
    all_freqs = np.asarray(list(inp['frequencies'].values()), dtype=float)
    observed = inp['observed']

    lopts = dict(inp['layered_opts'])
    method = lopts.pop('method', 'midpoint')
    lopts['return_imat'] = True

    if model.case in ('HTI', 'triaxial'):
        raise NotImplementedError(
            "Layered computation is implemented for isotropic and VTI "
            "models (as the reference).")
    vti = model.case == 'VTI'

    if want_grad:
        out = np.zeros((3, *model.shape))
        weights, residual = inp.get('weights'), inp.get('residual')
        if observed is None or weights is None or residual is None:
            return out        # nothing to differentiate against
    else:
        out = np.full((len(inp['receivers']), all_freqs.size),
                      np.nan + 1j * np.nan)

    # observed/weights/residual: (nrec, nfreq) ndarrays (or None),
    # positionally aligned with the receiver-dict order.
    for i, rec in enumerate(inp['receivers'].values()):
        # Frequencies with data for this receiver (all, if no data).
        live = (np.isfinite(np.asarray(observed[i]))
                if observed is not None
                else np.ones(all_freqs.size, dtype=bool))
        if not live.any():
            continue

        # 1-D column under the src-rec pair + its spread-back weights.
        oned, imat = model.extract_1d(
            **_get_points(method, inp['src'], rec), **lopts)
        to_cond = oned.map.backward
        cond_h = to_cond(oned.property_x[0, 0, :])
        cond_v = to_cond(oned.property_z[0, 0, :]) if vti else None
        fwd = {'src': inp['src'], 'rec': rec, 'freqs': all_freqs[live],
               'depth': oned.grid.nodes_z[1:-1]}

        if not want_grad:
            out[i, live] = _layered_fwd(cond_h, cond_v, fwd)
            continue

        obs, wgt, res = (np.asarray(a[i])[live]
                         for a in (observed, weights, residual))
        misfit = np.sum(wgt * (res.conj() * res)).real / 2
        args = (cond_h, cond_v, obs, wgt, misfit, fwd, imat)
        out[0] += _fd_gradient(*args, vertical=False)
        if vti:
            out[2] += _fd_gradient(*args, vertical=True)

    return out


def _layered_fwd(cond_h, cond_v, fwd_inp):
    """Responses of one src-rec pair over frequencies (native engine)."""
    import numpy as np
    from emg3d_tpu_torch import layered as _layered

    src = fwd_inp['src']
    rec = fwd_inp['rec']
    aniso = None if cond_v is None else np.sqrt(cond_h / cond_v)

    src_pt = (*src.center, src.azimuth, src.elevation)
    rec_pt = np.atleast_2d([*rec.center, rec.azimuth, rec.elevation])
    rec_type = rec.xtype

    out = np.empty(len(fwd_inp['freqs']), dtype=np.complex128)
    for i, freq in enumerate(fwd_inp['freqs']):
        resp = _layered.dipole_layered(
            src_pt, rec_pt, fwd_inp['depth'], 1.0 / cond_h, freq,
            aniso=aniso, rec_type=rec_type)
        out[i] = resp[0] * src.strength
    return out


def _get_points(method, src, rec):
    """Extraction-line kwargs for ``Model.extract_1d``.

    The 1-D column is taken along the horizontal src->rec segment;
    'source'/'receiver' collapse the segment onto that endpoint (a
    degenerate 'midpoint' line).  Same semantics as the reference
    (_multiprocessing.py:356-390).
    """
    ends = {'source': (src, src), 'receiver': (rec, rec)}
    a, b = ends.get(method, (src, rec))
    return {'method': 'midpoint' if method in ends else method,
            'p0': tuple(a.center[:2]), 'p1': tuple(b.center[:2])}


def _fd_gradient(cond_h, cond_v, data, weight, misfit, fwd_inp, imat,
                 vertical):
    """Misfit gradient w.r.t. the 1-D conductivities by forward FD.

    One forward evaluation per layer, with that layer's (horizontal or
    vertical) conductivity perturbed by +0.01 %, differenced against
    the unperturbed misfit — the reference's scheme
    (_multiprocessing.py:395-463).  The layer sensitivities are spread
    back onto the 3-D grid by the extraction weights ``imat``.
    """
    import numpy as np

    base = np.asarray(cond_v if vertical else cond_h, dtype=float)

    def half_misfit(resp):
        d = resp - data
        return float(np.sum(weight * (d.conj() * d)).real) / 2

    sens = np.empty_like(base)
    for iz, c in enumerate(base):
        step = 1e-4 * c
        pert = base.copy()
        pert[iz] = c + step
        hv = (cond_h, pert) if vertical else (pert, cond_v)
        sens[iz] = (half_misfit(_layered_fwd(*hv, fwd_inp))
                    - misfit) / step

    return imat[..., None] * sens[None, :]
