"""Native inversion: minimize a Simulation's data misfit.

Port of ``emg3d_tpu.inversion.native`` (same names and behaviour).  The
reference defers 3-D inversion to external frameworks (SimPEG, pyGIMLi)
through placeholder bridges (emg3d/inversion/simpeg.py:39-47).  This
module is a small self-contained optimizer loop: a bound-constrained
quasi-Newton (L-BFGS-B) or nonlinear-CG inversion directly on
:class:`emg3d_tpu_torch.simulations.Simulation` — misfit and
adjoint-state gradient come from the simulation, model updates happen in
the model's mapping space (use a log mapping, e.g. ``'LgResistivity'`` or
``'LnConductivity'``, for positivity and scale invariance).

Example
-------
>>> sim = emg3d_tpu_torch.Simulation(survey=survey, model=model0, ...)
>>> result = emg3d_tpu_torch.inversion.native.minimize(sim, maxiter=10)
>>> inverted = result.model

The optimizer runs on the host (scipy); every misfit/gradient
evaluation is a full multigrid forward + adjoint pass on the
simulation's device.  Every evaluation builds a new ``Model`` on the same
grid, so on the card its solves replay the whole-cycle CUDA graphs the
first evaluation captured.
"""

import time
from dataclasses import dataclass, field

import numpy as np

from emg3d_tpu_torch import models

__all__ = ['minimize', 'InversionResult']


def __dir__():
    return __all__


@dataclass
class InversionResult:
    """Outcome of :func:`minimize`."""

    model: object                 # final Model
    misfit: float                 # final data misfit
    misfit0: float                # initial data misfit
    n_iterations: int
    n_evaluations: int
    success: bool
    message: str
    history: list = field(default_factory=list)   # misfit per evaluation

    def __repr__(self):
        return (f"InversionResult(misfit={self.misfit:.4e} "
                f"(from {self.misfit0:.4e}), "
                f"iterations={self.n_iterations}, "
                f"evaluations={self.n_evaluations}, "
                f"success={self.success})")


# Parameterized properties per anisotropy case, in the slot order of
# Simulation.gradient's leading axis (simulations.py gradient/jtvec).
_CASE_PROPS = {
    'isotropic': ('property_x',),
    'HTI': ('property_x', 'property_y'),
    'VTI': ('property_x', 'property_z'),
    'triaxial': ('property_x', 'property_y', 'property_z'),
}


def _make_objective(sim):
    """(fun, set_model, m0) for ``sim`` in the parameter-vector space.

    Parameter-vector convention: one Fortran-order flattened block per
    parameterized property (isotropic: 1 block; HTI/VTI: 2; triaxial:
    3), concatenated in the gradient's slot order — m0, the gradient,
    and set_model's reshape must all agree or the gradient the
    optimizer sees is permuted relative to its parameter vector.
    ``fun(m) -> (misfit, grad)`` runs a forward + adjoint pass.
    """
    grid = sim.model.grid
    mapping = sim.model.map.name
    shape = sim.model.shape
    props = _CASE_PROPS[sim.model.case]
    nblock = int(np.prod(shape))

    m0 = np.concatenate([
        np.asarray(getattr(sim.model, p), dtype=np.float64).ravel(order='F')
        for p in props])

    def blocks(m):
        m = np.asarray(m, dtype=np.float64)
        return {p: m[i * nblock:(i + 1) * nblock]
                .reshape(shape, order='F').copy()
                for i, p in enumerate(props)}

    def set_model(m):
        sim.model = models.Model(grid, mapping=mapping, **blocks(m))
        # 'computed' resets the synthetic data, misfit and gradient so
        # the next access recomputes with the new model ('keepresults'
        # would keep them — reference clean semantics).
        sim.clean('computed')

    def fun(m):
        set_model(m)
        phi_d = float(sim.misfit)
        g = np.asarray(sim.gradient, dtype=np.float64)
        if g.ndim == 3:                    # isotropic: (nx, ny, nz)
            g = g[None]
        grad = np.concatenate([g[i].ravel(order='F')
                               for i in range(len(props))])
        return phi_d, grad

    return fun, set_model, m0


def _make_roughness(shape, widths):
    """Per-block roughness functional ½‖D m‖² and its gradient.

    D is the first-difference operator between neighbouring cell
    centres along each axis, scaled by the inverse centre distance
    (so the penalty approximates ∫|∇m|² dV up to a volume factor and
    is invariant under grid refinement of a smooth model).  Returns
    ``rough(mblock, axis_weights) -> (phi_s, grad_block)`` with
    ``mblock`` of shape ``shape``.
    """
    # Inverse distances between neighbouring cell centres, broadcast
    # to the difference arrays' shapes.
    inv_d = []
    for ax, hx in enumerate(widths):
        d = 0.5 * (hx[:-1] + hx[1:])          # centre-to-centre
        bshape = [1, 1, 1]
        bshape[ax] = d.size
        inv_d.append((1.0 / d).reshape(bshape))

    def rough(mb, axw):
        phi = 0.0
        grad = np.zeros(shape, dtype=np.float64)
        for ax in range(3):
            w = axw[ax]
            if not w:
                continue
            diff = np.diff(mb, axis=ax) * inv_d[ax]
            phi += 0.5 * w * float((diff * diff).sum())
            g = w * diff * inv_d[ax]          # adjoint of scaled diff
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax] = slice(None, -1)
            hi[ax] = slice(1, None)
            grad[tuple(lo)] -= g
            grad[tuple(hi)] += g
        return phi, grad

    return rough


def minimize(simulation, maxiter=10, method='L-BFGS-B', bounds=None,
             tol=1e-8, regularization=0.0, reference_model=None,
             smoothness=0.0, callback=None, verb=1):
    """Minimize the simulation's data misfit over its model parameters.

    Parameters
    ----------
    simulation : Simulation
        Forward simulation with observed data.  All four anisotropy
        cases invert (the parameter vector holds one block per
        parameterized property); the mapping defines the inversion
        parameterization (log mappings recommended).  The simulation is
        used in place: on return its model is the inverted one.
    maxiter : int
        Maximum optimizer iterations.
    method : str
        Any scipy.optimize gradient method ('L-BFGS-B', 'CG', 'TNC', …).
    bounds : tuple (lower, upper), optional
        Per-parameter bounds in mapping space (scalars broadcast).
    tol : float
        Optimizer tolerance (scipy ``tol``).
    regularization : float
        Tikhonov weight α of the penalty ½α‖m − m_ref‖² added to the
        data misfit (a minimal smoother/damper; 0 disables).
    reference_model : ndarray, optional
        m_ref of the penalty (default: the starting model).
    smoothness : float or (float, float, float)
        Weight β of the roughness penalty ½β‖D m‖², where D takes
        first differences between neighbouring cell centres (scaled by
        the inverse centre distance) along each axis; a 3-tuple gives
        per-axis weights (e.g. ``(1, 1, 0.1)`` to allow sharper
        vertical layering).  Applied per parameterized property block.
        0 disables.
    callback : callable, optional
        ``callback(iteration, misfit, model_vector)`` after each
        optimizer iteration.
    verb : int
        0: silent; 1: one line per iteration.

    Returns
    -------
    InversionResult
    """
    import scipy.optimize

    sim = simulation
    data_fun, set_model, m0 = _make_objective(sim)
    m_ref = (m0.copy() if reference_model is None
             else np.asarray(reference_model,
                             dtype=np.float64).ravel(order='F'))

    axw = tuple(np.broadcast_to(
        np.asarray(smoothness, dtype=np.float64), (3,)))
    if any(axw):
        shape = sim.model.shape
        nblock = int(np.prod(shape))
        rough = _make_roughness(
            shape, [np.asarray(h, dtype=np.float64)
                    for h in sim.model.grid.h])
    state = {'n_eval': 0, 'n_it': 0, 'best': None, 'history': [],
             'misfit0': None, 't0': time.time()}

    def fun(m):
        phi_d, grad = data_fun(m)
        state['n_eval'] += 1
        if state['misfit0'] is None:
            state['misfit0'] = phi_d
        phi = phi_d
        if regularization:
            dm = m - m_ref
            phi = phi + 0.5 * regularization * float(dm @ dm)
            grad = grad + regularization * dm
        if any(axw):
            grad = np.array(grad, dtype=np.float64, copy=True)
            for i in range(m.size // nblock):
                sl = slice(i * nblock, (i + 1) * nblock)
                phi_s, gs = rough(
                    m[sl].reshape(shape, order='F'), axw)
                phi = phi + phi_s
                grad[sl] += gs.ravel(order='F')
        state['history'].append(phi_d)
        if state['best'] is None or phi_d <= state['best'][0]:
            state['best'] = (phi_d, m.copy())
        return phi, grad

    def cb(m):
        state['n_it'] += 1
        phi = state['history'][-1] if state['history'] else np.nan
        if verb > 0:
            print(f"   it {state['n_it']:3d}: misfit {phi:.4e}   "
                  f"[{time.time() - state['t0']:.1f} s; "
                  f"{state['n_eval']} evaluations]")
        if callback is not None:
            callback(state['n_it'], phi, m)

    if bounds is not None:
        lo, hi = bounds
        bounds = list(zip(np.broadcast_to(lo, m0.shape),
                          np.broadcast_to(hi, m0.shape)))

    res = scipy.optimize.minimize(
        fun, m0, jac=True, method=method, bounds=bounds, tol=tol,
        callback=cb, options={'maxiter': maxiter})

    # Leave the simulation holding the best-misfit model.
    best_phi, best_m = state['best']
    set_model(best_m)

    return InversionResult(
        model=sim.model, misfit=best_phi, misfit0=state['misfit0'],
        n_iterations=state['n_it'], n_evaluations=state['n_eval'],
        success=bool(res.success), message=str(res.message),
        history=state['history'])
