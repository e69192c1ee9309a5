"""A homogeneous, possibly anisotropic fullspace on a uniform grid
centred on the origin, and x-directed point dipoles at the traffic's
positions.

Returns ``h`` (three cell-width arrays), ``origin``, ``rho`` (three
resistivity arrays, x, y, z), ``frequency`` and ``sources`` (rows of
x, y, z, azimuth 0, elevation 0).  The traffic gives
``source_positions_m``, the same set for every seed, so that every seed
does the same work (the cycles a solve takes depend on where its source
is); the seed draws their order.
"""

import numpy as np


def build(config, traffic, rng):
    cells, width = config["cells"], config["cell_width_m"]
    positions = np.asarray(traffic["source_positions_m"], dtype=float)
    return {
        "h": [np.full(n, width) for n in cells],
        "origin": [-n * width / 2 for n in cells],
        "rho": [np.full(cells, r) for r in config["resistivity_ohm_m"]],
        "frequency": config["frequency_hz"],
        "sources": np.array([(*p, 0.0, 0.0)
                             for p in positions[rng.permutation(
                                 len(positions))]]),
    }
