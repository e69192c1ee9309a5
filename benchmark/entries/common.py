"""What the entries share: the program's field components, the control's
rounding, the solver options, and the reference's side of a field
check."""

import numpy as np
import torch

from benchmark.reference import maxwell, sources


def components(field):
    """The three edge components of a field of the program."""
    return (field.fx, field.fy, field.fz)


def rounded(field):
    """The components rounded to complex64: the control's field."""
    return tuple(np.asarray(c).astype(np.complex64).astype(complex)
                 for c in field)


def program_options(config, device):
    """The solver options of the configuration; ``device`` is passed to
    the program only off the card (its default is the card)."""
    opts = dict(config["solver"])
    if torch.device(device).type != "cuda":
        opts["device"] = str(device)
    return opts


class Reference:
    """The reference's operator for one model, on ``device``."""

    def __init__(self, inputs, rho, device):
        self.grid = maxwell.Grid(inputs["h"], inputs["origin"])
        self.frequency = inputs["frequency"]
        self.device = device
        self.eta, self.zeta = maxwell.eta_zeta(
            self.grid, rho, self.frequency, device)
        self.h = tuple(torch.as_tensor(w, device=device)
                       for w in self.grid.h)

    def source(self, row):
        """The right-hand side of a point source (x, y, z, azm, elv)."""
        return sources.point_field(self.grid, row[:3],
                                   sources.orientation(*row[3:]), 1.0,
                                   self.frequency)

    def residual(self, rhs, field):
        """||s - A e|| / ||s|| of a field's components."""
        return maxwell.rel_residual(
            maxwell.to_device(rhs, self.device),
            maxwell.to_device(field, self.device), self.eta, self.zeta,
            self.h)
