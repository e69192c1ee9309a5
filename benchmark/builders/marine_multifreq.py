"""The canonical marine model of :mod:`benchmark.builders.marine` at
several frequencies.

Builds what ``marine.build`` builds from the same configuration keys,
and returns the configuration's ``frequencies_hz`` as ``frequencies``
(a list, in their order) in place of ``frequency``.
"""

from benchmark.builders import marine


def build(config, traffic, rng):
    inputs = marine.build({**config, "frequency_hz": None}, traffic, rng)
    del inputs["frequency"]
    inputs["frequencies"] = [float(f) for f in config["frequencies_hz"]]
    return inputs
