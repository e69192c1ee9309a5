"""Survey simulation with misfit, adjoint gradient and J·v products on a
CUDA card.

The PyTorch port of ``02_gradient_and_sensitivities.py``: a two-source,
multi-receiver survey over a small model; synthetic "observed" data with
noise (from a fixed seed), then the data misfit, the adjoint-state
gradient and a Jacobian-vector product.

Run from the repository root:

    python examples/torch_02_gradient_and_sensitivities.py          # card
    python examples/torch_02_gradient_and_sensitivities.py --cpu    # CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np                                    # noqa: E402
import emg3d_tpu_torch as emg3d                       # noqa: E402


def main(argv=None):
    """Compute and print misfit, gradient and J·v; returns
    {'misfit', 'gradient_shape', 'gradient_max', 'jvec_max'}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    device = 'cpu' if parser.parse_args(argv).cpu else None

    grid = emg3d.TensorMesh([np.full(24, 100.0)] * 3,
                            origin=(-1200, -1200, -2000))
    res = np.ones(grid.shape_cells)
    res[:, :, grid.cell_centers_z > -400] = 0.3
    model = emg3d.Model(grid, property_x=res, mapping='Resistivity')

    survey = emg3d.Survey(
        sources=[emg3d.TxElectricPoint((x, 0, -500, 0, 0))
                 for x in (-400.0, 400.0)],
        receivers=[emg3d.RxElectricPoint((x, 0, -600, 0, 0))
                   for x in np.arange(-800, 801, 400.0)],
        frequencies=1.0,
        noise_floor=1e-15, relative_error=0.05)

    sim = emg3d.Simulation(
        survey=survey, model=model, gridding='same', verb=-1,
        receiver_interpolation='linear', tqdm_opts=False, device=device)

    # Synthetic observed data (with noise), then misfit + gradient.
    sim.compute(observed=True, add_noise=True,
                rng=np.random.default_rng(2))
    misfit = sim.misfit
    print(f"misfit: {misfit:.4e}")

    grad = sim.gradient
    print(f"gradient shape {grad.shape}; "
          f"max |dphi/dm| = {np.max(np.abs(grad)):.3e}")

    # Jacobian-vector product for a model perturbation.
    v = np.zeros(model.shape)
    v[10:14, 10:14, 8:12] = 1.0
    jv = sim.jvec(v)
    print(f"jvec: {np.nanmax(np.abs(jv)):.3e} max data perturbation")
    return {'misfit': misfit, 'gradient_shape': grad.shape,
            'gradient_max': float(np.max(np.abs(grad))),
            'jvec_max': float(np.nanmax(np.abs(jv)))}


if __name__ == "__main__":
    main()
