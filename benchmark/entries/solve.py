"""A closed loop of one caller: ``emg3d_tpu_torch.solve(model, sfield)``
on each of the cell's source fields in turn, with the configuration's
solver options (on the card every cycle a replay of a captured CUDA
graph).  An answer is a returned field; the check is its relative
residual against the reference's operator and source.  The control is
the field rounded to complex64."""

import emg3d_tpu_torch as e3

from benchmark.entries.common import (Reference, components,
                                      program_options, rounded)


class Entry:
    def __init__(self, inputs, config, traffic, device, rng):
        self.inputs = inputs
        self.opts = program_options(config, device)
        grid = e3.TensorMesh(inputs["h"], origin=inputs["origin"])
        rx, ry, rz = inputs["rho"]
        self.model = e3.Model(grid, property_x=rx, property_y=ry,
                              property_z=rz, mapping="Resistivity")
        self.sfields = [
            e3.get_source_field(grid, e3.TxElectricPoint(tuple(row)),
                                inputs["frequency"])
            for row in inputs["sources"]]
        self.warm_solves = traffic.get("warm_solves", 0)
        self.cycles, self.failed = [], 0

    def warm(self):
        for sfield in self.sfields[:self.warm_solves]:
            e3.solve(self.model, sfield, **self.opts)

    def step(self, i, keep):
        k = i % len(self.sfields)
        efield, info = e3.solve(self.model, self.sfields[k],
                                return_info=True, **self.opts)
        self.cycles.append(info["it_mg"])
        self.failed += info["exit"] != 0
        keep((k, components(efield)))
        return 1

    def release(self):
        self.model = self.sfields = None

    def check(self, kept, device):
        ref = Reference(self.inputs, self.inputs["rho"], device)
        return {"residual": max(
            ref.residual(ref.source(self.inputs["sources"][k]), field)
            for k, field in kept)}

    def control(self, answer):
        k, field = answer
        return k, rounded(field)
