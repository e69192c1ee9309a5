"""A closed loop of one caller: one gradient-based inversion iterate per
step, through the program's public survey layer.

Set-up computes the observed data once, the program's responses of the
true model (``Simulation.compute(observed=True, add_noise=False)``),
then runs ``warm_steps`` iterates.  A step builds a fresh ``Model``
whose resistor has the next of the traffic's resistivities and a fresh
``Simulation`` on the configuration's gridding, reads its ``gradient``
(the forward solves, the misfit, the adjoint sources, the adjoint
solves and the assembly) and then its ``misfit`` (cached): one answer.
``cycles`` holds ``it_mg`` of every forward and adjoint solve,
``failed`` counts the solves whose ``exit`` is not 0.

The check takes the program's fields (``get_efield``, ``get_bfield``)
and its grid, data, misfit and gradient, and holds them against
:mod:`benchmark.reference.survey` on the reference's own volume
averaging of the model: the relative residuals of the forward and
adjoint fields (the adjoint source built by the reference from the
program's data residual and weights), the responses, the misfit and
the gradient.  The control rounds both kinds of field to complex64.
"""

import numpy as np
import torch

import emg3d_tpu_torch as e3

from benchmark.entries.common import components, rounded
from benchmark.reference import maxwell, sources
from benchmark.reference import survey as reference


class Entry:
    def __init__(self, inputs, config, traffic, device, rng):
        # A program without the getter of the adjoint fields fails here,
        # at set-up.
        self.get_bfield = e3.Simulation.get_bfield
        self.get_bfield_info = e3.Simulation.get_bfield_info
        self.inputs = inputs
        self.grid = e3.TensorMesh(inputs["h"], origin=inputs["origin"])
        self.options = {**config["simulation"],
                        "solver_opts": dict(config["solver"]),
                        "tqdm_opts": False}
        if torch.device(device).type != "cuda":
            self.options["device"] = str(device)
        self.warm_steps = traffic.get("warm_steps", 0)
        self.observed = None
        self.cycles, self.failed = [], 0

    def _simulation(self, rho, observed):
        inp = self.inputs
        survey = e3.Survey(
            [e3.TxElectricPoint(tuple(r)) for r in inp["sources"]],
            [e3.RxElectricPoint(tuple(r)) for r in inp["receivers"]],
            [inp["frequency"]], data=observed,
            relative_error=inp["relative_error"],
            noise_floor=inp["noise_floor"])
        model = e3.Model(self.grid, property_x=rho, mapping="Resistivity")
        return e3.Simulation(survey, model, **self.options)

    def warm(self):
        sim = self._simulation(self.inputs["rho_true"], None)
        sim.compute(observed=True, add_noise=False)
        self.observed = np.asarray(sim.data.observed).copy()
        for i in range(self.warm_steps):
            self.step(i, lambda answer: None)

    def step(self, i, keep):
        inp = self.inputs
        value = inp["steps"][i % len(inp["steps"])]
        rho = np.where(inp["resistor"], value, inp["rho_background"])
        sim = self._simulation(rho, self.observed)
        grad = sim.gradient
        misfit = sim.misfit
        pairs = [(s, f) for s in sim.survey.sources
                 for f in sim.survey.frequencies]
        for s, f in pairs:
            for info in (sim.get_efield_info(s, f),
                         self.get_bfield_info(sim, s, f)):
                self.cycles.append(info["it_mg"])
                self.failed += info["exit"] != 0
        grid = sim.get_grid(*pairs[0])
        keep({
            "rho": rho,
            "h": [np.asarray(w) for w in grid.h],
            "origin": np.asarray(grid.origin),
            "efields": [components(sim.get_efield(s, f)) for s, f in pairs],
            "bfields": [components(self.get_bfield(sim, s, f))
                        for s, f in pairs],
            "observed": self.observed[:, :, 0],
            "synthetic": np.asarray(sim.data.synthetic)[:, :, 0],
            "residual": np.asarray(sim.data.residual)[:, :, 0],
            "weights": np.asarray(sim.data.weights)[:, :, 0],
            "misfit": misfit,
            "gradient": np.asarray(grad),
        })
        return 1

    def release(self):
        self.grid = self.observed = None

    def check(self, kept, device):
        inp = self.inputs
        mesh = maxwell.Grid(inp["h"], inp["origin"])
        freq = inp["frequency"]
        out = dict.fromkeys(("residual_forward", "residual_adjoint",
                             "responses", "misfit", "gradient"), 0.0)

        def worst(name, value):
            out[name] = max(out[name], value)

        for a in kept:
            grid = maxwell.Grid(a["h"], a["origin"])
            rho = reference.volume_average(mesh, a["rho"], grid)
            eta, zeta = maxwell.eta_zeta(grid, (rho,) * 3, freq, device)
            h = tuple(torch.as_tensor(w, device=device) for w in grid.h)

            def residual(rhs, field):
                return maxwell.rel_residual(
                    maxwell.to_device(rhs, device),
                    maxwell.to_device(field, device), eta, zeta, h)

            synthetic = []
            for k, row in enumerate(inp["sources"]):
                rhs = sources.point_field(grid, row[:3],
                                          sources.orientation(*row[3:5]),
                                          1.0, freq)
                worst("residual_forward", residual(rhs, a["efields"][k]))
                rhs = reference.adjoint_source(
                    grid, inp["receivers"], a["residual"][k],
                    a["weights"][k], freq)
                worst("residual_adjoint", residual(rhs, a["bfields"][k]))
                synthetic.append(reference.responses(
                    grid, a["efields"][k], inp["receivers"]))
            synthetic = np.array(synthetic)
            worst("responses", float(np.max(np.abs(
                synthetic - a["synthetic"])) / np.max(np.abs(synthetic))))
            w = reference.weights(a["observed"], inp["relative_error"],
                                  inp["noise_floor"])
            m = reference.misfit(synthetic, a["observed"], w)
            worst("misfit", abs(a["misfit"] - m) / m)
            g = reference.gradient(grid, mesh, a["rho"], a["efields"],
                                   a["bfields"], freq)
            worst("gradient", float(np.max(np.abs(a["gradient"] - g))
                                    / np.max(np.abs(g))))
        return out

    def control(self, answer):
        return {**answer,
                "efields": [rounded(f) for f in answer["efields"]],
                "bfields": [rounded(f) for f in answer["bfields"]]}
