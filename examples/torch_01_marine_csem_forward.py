"""Marine CSEM forward model on a CUDA card: resistive target under sea water.

The PyTorch port of ``01_marine_csem_forward.py``: automatic gridding, a
layered background with a buried resistor and a multi-offset receiver
line, one solve with the default solver (without line relaxation, as
there) on the card.

Run from the repository root:

    python examples/torch_01_marine_csem_forward.py          # on the card
    python examples/torch_01_marine_csem_forward.py --cpu    # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np                                    # noqa: E402
import emg3d_tpu_torch as emg3d                       # noqa: E402


def main(argv=None):
    """Solve and print the responses; returns them with the solver's info:
    {'exit_message', 'it_mg', 'it_ssl', 'offsets', 'responses'}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    device = 'cpu' if parser.parse_args(argv).cpu else None

    frequency = 1.0
    src = (0, 0, -950, 0, 0)        # x-dipole 50 m above the seafloor

    # Automatic gridding: water (0.3) to background (1) Ohm m.
    grid = emg3d.construct_mesh(
        frequency=frequency, properties=[0.3, 1.0, 1.0, 0.3],
        center=(0, 0, -1000), seasurface=0.0,
        domain=([-3000, 3000], [-400, 400], [-2400, 0]),
        min_width_limits=200.0, verb=0)
    print(grid)

    # Model: sea water above -1000 m, halfspace below, 100 Ohm m target.
    res = np.ones(grid.shape_cells)
    zc = grid.cell_centers_z
    res[:, :, zc > -1000] = 0.3
    xc, yc = grid.cell_centers_x, grid.cell_centers_y
    tgt = ((np.abs(xc[:, None, None]) < 1500)
           & (np.abs(yc[None, :, None]) < 3000)
           & (zc[None, None, :] > -1900) & (zc[None, None, :] < -1700))
    res[tgt] = 100.0
    model = emg3d.Model(grid, property_x=res, mapping='Resistivity')

    efield, info = emg3d.solve_source(
        model, src, frequency, return_info=True, verb=1,
        linerelaxation=False, device=device)
    print(f"solver: {info['exit_message']} in {info['it_mg']} MG / "
          f"{info['it_ssl']} Krylov iterations")

    offsets = np.arange(500, 3001, 500.0)
    resp = np.asarray(emg3d.get_receiver(
        efield, (offsets, np.zeros_like(offsets),
                 np.full_like(offsets, -1000.0), 0, 0)))
    for off, r in zip(offsets, resp):
        print(f"  offset {off:6.0f} m:  |E| = {abs(r):.3e} V/m   "
              f"phase = {np.angle(r, deg=True):7.2f}°")
    return {'exit_message': info['exit_message'], 'it_mg': info['it_mg'],
            'it_ssl': info['it_ssl'], 'offsets': offsets, 'responses': resp}


if __name__ == "__main__":
    main()
