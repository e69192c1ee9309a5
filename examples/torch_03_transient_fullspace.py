"""Time-domain (transient) modelling via the Fourier machinery.

The PyTorch port of ``03_transient_fullspace.py``: frequency-domain
responses at the Fourier-required frequencies are transformed to a
transient switch-off response and compared with the closed-form
fullspace solution.  The frequency sweep uses the layered (1-D) engine,
which runs on the host, so the example takes seconds and ``--cpu``
changes nothing; ``emg3d_tpu_torch.northstar.time_domain`` does the same
with one 3-D solve per frequency on the card.

Run from the repository root:

    python examples/torch_03_transient_fullspace.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np                                    # noqa: E402
import emg3d_tpu_torch as emg3d                       # noqa: E402
from emg3d_tpu_torch import layered                   # noqa: E402


def main(argv=None):
    """Print the transient beside the closed form; returns
    {'times', 'computed', 'exact', 'error'} (relative error per time)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="accepted as by the other examples; the 1-D "
                             "engine runs on the host either way")
    parser.parse_args(argv)

    times = np.logspace(-2, 1, 13)
    offset = 900.0
    res = 1.0

    fourier = emg3d.Fourier(time=times, fmin=1e-3, fmax=1e2, signal=-1)
    print(f"{fourier.freq_required.size} required frequencies, "
          f"{fourier.freq_compute.size} to compute "
          f"[{fourier.freq_compute[0]:.2e}, "
          f"{fourier.freq_compute[-1]:.2e}] Hz")

    # Frequency sweep (1-D engine; x-dipole, inline receiver).
    fresp = np.array([
        layered.dipole_layered((0, 0, 0, 0, 0), [(offset, 0, 0, 0, 0)],
                               [], [res], f)[0]
        for f in fourier.freq_compute])

    tresp = np.asarray(fourier.freq2time(fresp, offset)).ravel()

    # Closed-form transient switch-off response for comparison.
    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "..", "tests"))
    import alternatives
    exact = alternatives.fullspace_dipole_time(
        np.array([[offset, 0., 0.]]), (0., 0., 0.), times, res,
        signal=-1)[:, 0, 0]

    error = np.abs(tresp - exact) / np.abs(exact)
    print(f"{'t [s]':>8} {'E computed':>13} {'E exact':>13} {'err':>8}")
    for t, c, e, r in zip(times, tresp, exact, error):
        print(f"{t:8.3f} {c:13.4e} {e:13.4e} {r:8.1%}")
    return {'times': times, 'computed': tresp, 'exact': exact,
            'error': error}


if __name__ == "__main__":
    main()
