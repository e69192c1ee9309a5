"""Builders of a configuration's inputs, one module per ``builder`` name
of ``configs/<config>.json``.  Each has ``build(config, traffic, rng)``
and returns plain NumPy inputs, which the program and the reference
both take."""
