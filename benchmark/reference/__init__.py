"""The plain reference that decides ``correct``.

The discrete system that emg3d solves (the volume-scaled curl-curl
operator of Mulder (2006) on a staggered tensor grid with PEC
boundaries) and its point sources, written out in plain PyTorch and
NumPy in complex128.  It takes plain arrays (cell widths,
resistivities, positions, the program's field components) and imports
nothing of the program under test, nor ``jax``.

- :mod:`.maxwell`: the grid, the operator and a field's relative
  residual against a right-hand side.
- :mod:`.sources`: the right-hand side of an electric point source.
"""
