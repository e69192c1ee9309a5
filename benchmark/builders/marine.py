"""The canonical marine model (sea, sediments, a buried resistor) on an
inversion mesh, with seafloor receivers and sources in the water.

The mesh's core has ``cells`` cells of ``cell_width_m``, x and y centred
on 0, z from the sea surface (z = 0) down; ``padding_cells`` cells
growing by ``padding_growth`` follow on every side, those above the
core in the air.  Each cell takes the resistivity of the layer or body
its centre lies in: air above z = 0, sea water down to the seafloor at
``-water_depth_m``, sediment below, and the resistor, ``resistor_width_m``
wide in x and y, centred on 0, ``resistor_thickness_m`` thick, its top
``resistor_top_below_seafloor_m`` below the seafloor.

Returns ``h`` (three cell-width arrays), ``origin``, ``rho_background``
(the resistivities without the resistor), ``resistor`` (a boolean mask
of its cells), ``rho_true`` (with the configuration's resistor),
``steps`` (the traffic's resistor resistivities in an order drawn from
the seed), ``sources`` (rows of x, y, z, azimuth 0, elevation 0, at the
traffic's ``source_positions_m``), ``receivers`` (the same rows for the
receivers, x-directed, ``receiver_height_m`` above the seafloor on an
array of ``receiver_layout`` over the middle two-thirds of the core),
``frequency``, ``relative_error`` and ``noise_floor``.
"""

import numpy as np


def _widths(n, width, pad, growth):
    """Core cells of ``width`` with ``pad`` growing cells on each side."""
    grow = width * growth ** np.arange(1, pad + 1)
    return np.concatenate([grow[::-1], np.full(n, width), grow])


def _centres(h, origin):
    nodes = origin + np.concatenate([[0.0], np.cumsum(h)])
    return (nodes[:-1] + nodes[1:]) / 2


def build(config, traffic, rng):
    cells, width = config["cells"], config["cell_width_m"]
    pad, growth = config["padding_cells"], config["padding_growth"]
    h = [_widths(n, w, p, growth) for n, w, p in zip(cells, width, pad)]
    core = [n * w for n, w in zip(cells, width)]
    origin = [-core[0] / 2 - h[0][:pad[0]].sum(),
              -core[1] / 2 - h[1][:pad[1]].sum(),
              -core[2] - h[2][:pad[2]].sum()]
    x, y, z = np.meshgrid(*(_centres(w, o) for w, o in zip(h, origin)),
                          indexing="ij")

    rho = config["resistivity_ohm_m"]
    seafloor = -config["water_depth_m"]
    top = seafloor - config["resistor_top_below_seafloor_m"]
    bottom = top - config["resistor_thickness_m"]
    half = [w / 2 for w in config["resistor_width_m"]]
    background = np.where(z > 0, rho["air"], np.where(
        z > seafloor, rho["seawater"], rho["sediment"]))
    resistor = ((np.abs(x) < half[0]) & (np.abs(y) < half[1])
                & (z < top) & (z > bottom))

    positions = np.asarray(traffic["source_positions_m"], dtype=float)
    if len(positions) != config["source_count"]:
        raise ValueError(f"{len(positions)} source positions, the "
                         f"configuration has {config['source_count']}")
    nx, ny = config["receiver_layout"]
    rx, ry = np.meshgrid(np.linspace(-core[0] / 3, core[0] / 3, nx),
                         np.linspace(-core[1] / 3, core[1] / 3, ny),
                         indexing="ij")
    rz = seafloor + config["receiver_height_m"]
    steps = np.asarray(traffic["resistor_ohm_m"], dtype=float)
    return {
        "h": h,
        "origin": origin,
        "rho_background": background,
        "resistor": resistor,
        "rho_true": np.where(resistor, rho["resistor"], background),
        "steps": steps[rng.permutation(len(steps))],
        "sources": np.array([(*p, 0.0, 0.0) for p in positions]),
        "receivers": np.array([(a, b, rz, 0.0, 0.0) for a, b in
                               zip(rx.ravel(), ry.ravel())]),
        "frequency": config["frequency_hz"],
        "relative_error": config["relative_error"],
        "noise_floor": config["noise_floor"],
    }
