"""A closed loop of one caller: one
``emg3d_tpu_torch.solve_batch_fields(model, sfields)`` call per step on
all of the cell's source fields as lanes of one batched solve, with the
configuration's solver options given in full (the batch engine's
defaults are plain multigrid).  An answer is one lane's field; its check
and control are those of :mod:`benchmark.entries.solve`."""

import emg3d_tpu_torch as e3

from benchmark.entries import solve
from benchmark.entries.common import components


class Entry(solve.Entry):
    def warm(self):
        e3.solve_batch_fields(self.model, self.sfields, **self.opts)

    def step(self, i, keep):
        efields, info = e3.solve_batch_fields(self.model, self.sfields,
                                              **self.opts)
        for k, (efield, message) in enumerate(
                zip(efields, info["exit_messages"])):
            self.cycles.append(info["it_mg"])
            self.failed += message != "CONVERGED"
            keep((k, components(efield)))
        return len(efields)
