"""A closed loop of one caller: one forward evaluation of a trial model
per step, every source at every frequency, through the program's public
survey layer.

Set-up computes the observed data once, the program's responses of the
true model (``Simulation.compute(observed=True, add_noise=False)``),
then runs ``warm_steps`` steps.  A step builds a fresh ``Model`` whose
resistor has the next of the traffic's resistivities and a fresh
``Simulation`` on the configuration's gridding (under
``gridding='frequency'`` each frequency on its own grid, shared by the
sources), calls ``compute()`` (a solve of every (source, frequency)
pair and its responses) and reads ``misfit``: one answer.  ``cycles``
holds ``it_mg`` of every solve, ``failed`` counts the solves whose
``exit`` is not 0.

The check takes the program's fields, each with the grid it was solved
on, and its data and misfit, and holds them against
:mod:`benchmark.reference.survey`, pair by pair on the pair's own grid
and at the pair's own frequency: the relative residual of the e-field
with the reference's operator (on the reference's own volume averaging
of the model) and point source, the responses, and the misfit over
every source, receiver and frequency.  The control rounds the fields to
complex64.
"""

import numpy as np
import torch

import emg3d_tpu_torch as e3

from benchmark.entries.common import components, rounded
from benchmark.reference import maxwell, sources
from benchmark.reference import survey as reference


class Entry:
    def __init__(self, inputs, config, traffic, device, rng):
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
            list(inp["frequencies"]), data=observed,
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
        sim.compute()
        misfit = sim.misfit
        srcs, freqs = list(sim.survey.sources), list(sim.survey.frequencies)
        pairs = [(s, f) for s in range(len(srcs)) for f in range(len(freqs))]
        for s, f in pairs:
            info = sim.get_efield_info(srcs[s], freqs[f])
            self.cycles.append(info["it_mg"])
            self.failed += info["exit"] != 0
        grids = [sim.get_grid(srcs[s], freqs[f]) for s, f in pairs]
        keep({
            "rho": rho,
            "pairs": pairs,
            "grids": [([np.asarray(w) for w in g.h], np.asarray(g.origin))
                      for g in grids],
            "efields": [components(sim.get_efield(srcs[s], freqs[f]))
                        for s, f in pairs],
            "observed": self.observed,
            "synthetic": np.asarray(sim.data.synthetic),
            "misfit": misfit,
        })
        return 1

    def release(self):
        self.grid = self.observed = None

    def check(self, kept, device):
        # The reference multiplies no matrices on the card (its operator is
        # elementwise in complex128); this keeps any that a later change
        # adds out of TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        inp = self.inputs
        mesh = maxwell.Grid(inp["h"], inp["origin"])
        out = dict.fromkeys(("residual_forward", "responses", "misfit"), 0.0)

        def worst(name, value):
            # A NaN stays: max() would drop it.
            out[name] = np.nan if np.isnan(value) else max(out[name], value)

        for a in kept:
            synthetic = np.zeros(a["synthetic"].shape, dtype=complex)
            for (s, f), (h, origin), field in zip(a["pairs"], a["grids"],
                                                  a["efields"]):
                grid = maxwell.Grid(h, origin)
                freq = inp["frequencies"][f]
                rho = reference.volume_average(mesh, a["rho"], grid)
                eta, zeta = maxwell.eta_zeta(grid, (rho,) * 3, freq, device)
                row = inp["sources"][s]
                rhs = sources.point_field(grid, row[:3],
                                          sources.orientation(*row[3:5]),
                                          1.0, freq)
                worst("residual_forward", maxwell.rel_residual(
                    maxwell.to_device(rhs, device),
                    maxwell.to_device(field, device), eta, zeta,
                    tuple(torch.as_tensor(w, device=device)
                          for w in grid.h)))
                synthetic[s, :, f] = reference.responses(
                    grid, field, inp["receivers"])
            worst("responses", float(np.max(np.abs(
                synthetic - a["synthetic"])) / np.max(np.abs(synthetic))))
            w = reference.weights(a["observed"], inp["relative_error"],
                                  inp["noise_floor"])
            m = reference.misfit(synthetic, a["observed"], w)
            worst("misfit", abs(a["misfit"] - m) / m)
        return out

    def control(self, answer):
        return {**answer,
                "efields": [rounded(f) for f in answer["efields"]]}
