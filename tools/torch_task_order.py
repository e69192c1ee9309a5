"""The task loop of a survey on several grid shapes, in two task orders.

    python3 -m tools.torch_task_order [--max-steps N [N ...]]

Runs the task loop of ``chip_smoke.py``'s ``salt_128_frequency_gridding``
(the 128^3 salt model, 2 sources, 6 frequencies from 0.05 to 12 Hz, each
on its own automatic grid: 6 grids of 4 shapes; ``compute``, then
``misfit`` and ``gradient``) on the card, on whole-cycle graphs, for each
bound of the step cache (``solver._MAX_STEPS``, default 24 and 6), twice:
with the tasks in (source, frequency) order, as the task loop visited
them before it grouped them by grid shape, and in the order in which it
visits them now.  Each run starts from an empty step cache and prints
its captures and replays, the seconds and peak memory of its stages, and
the iterations of its tasks (``chip_smoke.gridding_engine``).  Needs a
card.
"""

import argparse

import chip_smoke as cs


def source_major(self, kind, srcfreq, payload, desc, tol):
    """``Simulation._solve_tasks`` with the tasks in ``srcfreq`` order."""
    from emg3d_tpu_torch.parallel import tasks

    def pack(sf):
        src, freq = sf
        data = {'model': self.model, 'solver_opts': self.solver_opts,
                **payload(src, freq)}
        data['solver_opts']['tol'] = tol
        return self._data_or_file(kind, src, freq, data)

    return tasks.process_map(tasks.solve, [pack(sf) for sf in srcfreq],
                             max_workers=self.max_workers,
                             **{'desc': desc, **self._tqdm_opts})


def main(argv=None):
    from emg3d_tpu_torch import simulations, solver

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--max-steps", type=int, nargs="+", default=[24, 6])
    args = parser.parse_args(argv)

    cs.phase_card()
    cs.phase_build()
    survey, model = cs.gridding_survey()
    by_shape = simulations.Simulation._solve_tasks
    bound = solver._MAX_STEPS
    try:
        for max_steps in args.max_steps:
            solver._MAX_STEPS = max_steps
            for order, solve_tasks in (("source, frequency", source_major),
                                       ("by grid shape", by_shape)):
                simulations.Simulation._solve_tasks = solve_tasks
                solver._STEPS.clear()
                stages, _, _ = cs.gridding_engine(
                    f"task loop, {order} order, step cache of {max_steps}",
                    survey, model, False, "task", ["gs_phase", "line_phase"])
                runs = [(s["seconds"], s["peak"]) for s in stages.values()]
                cs.log(f"[task order] {order}, step cache of {max_steps}: "
                       f"captures {solver.CYCLE_CAPTURES}, replays "
                       f"{solver.CYCLE_REPLAYS}, stages (s, peak B) {runs}")
    finally:
        simulations.Simulation._solve_tasks = by_shape
        solver._MAX_STEPS = bound
        solver._STEPS.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
