"""Small copies of the cells for the CPU tests: 16^3 grids, two sources
or lanes, no warm-up solves; one step each in a window of one second."""

import copy
import time

from benchmark import harness


def small(cell):
    workload, config = (copy.deepcopy(x) for x in harness.load_cell(cell))
    config["cells"] = [16, 16, 16]
    traffic = workload["traffic"]
    # The first two positions, scaled into the small grid.
    traffic["source_positions_m"] = [
        [v / 8 for v in p] for p in traffic["source_positions_m"][:2]]
    if "warm_solves" in traffic:
        traffic["warm_solves"] = 0
    return workload, config


def run(cell, tmp_path, seed=2 ** 31 + 11, control=False):
    workload, config = small(cell)
    return harness.run_cell(cell, seed, 1, 0, "cpu", time.perf_counter(),
                            tmp_path, workload=workload, config=config,
                            control=control)
