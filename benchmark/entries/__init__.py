"""The entries a cell's window drives, one module per ``entry`` name of
``workloads/<cell>.json``.  Each has a class ``Entry(inputs, config,
traffic, device, rng)`` with:

- ``warm()``: run the cell's own shapes once (set-up);
- ``step(i, keep)``: one timed step; hands each answer to ``keep`` and
  returns how many answers it completed;
- ``cycles`` (multigrid cycles of each answer) and ``failed`` (answers
  the program reported as not converged);
- ``release()``: drop the program's state;
- ``check(kept, device)``: {number: value} of the kept answers against
  the plain reference (``benchmark/reference``);
- ``control(answer)``: the answer as the control gives it (the check's
  numbers with the control in the program's place).
"""
