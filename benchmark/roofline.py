"""Least device time of the two hand-written kernels' phases.

Frozen copies of the work counts that ``chip_smoke.py`` logs
(``gs_phase_work``, ``line_phase_work``, ``bound_ms``), with the line
frames of ``ops/line_phase.py`` fixed here, so that a roofline counts the
same work whatever implements the kernel.  Bytes are computed from the
shapes (each input byte read once, each output byte written once, the
line phase's block-Thomas scratch left out), never measured.  Peaks are
NVIDIA's published H100 SXM rates at 700 W.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Real operations per point-phase node and per line group, counted from
# the kernels' arithmetic and rounded up (as chip_smoke.py counts them).
GS_FLOPS_PER_NODE = 1200
LINE_FLOPS_PER_GROUP = 2000
# Values per line and group of the line phase's scratch (kept apart).
SCRATCH_VALUES = 30
# Frame of the lines along each axis: frame axis i is axis FRAMES[a][i].
FRAMES = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 1, 0)}


def bound_s(nbytes, flops):
    """(least seconds of the card for the work, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def gs_phase_work(shape, color, item, ritem, tasks=1, stacked=False):
    """(bytes, flops) one point phase must move and do.

    The neighbouring edges the phase's nodes read (12 per node, shared
    between nodes), the 6 edges per node written and their sources read,
    the 8 cells around each node (3 eta of ``item`` bytes, zeta of
    ``ritem``) and the widths, once each.  ``tasks`` > 1: edges and
    sources per task; eta once with a per-task scale, or per task if
    ``stacked``.
    """
    nx, ny, nz = (len(range(1 + p, n, 2)) for n, p in zip(shape, color))
    nodes = nx * ny * nz
    read = (2 * nx * ((ny + 1) * nz + ny * (nz + 1))
            + 2 * ny * ((nx + 1) * nz + nx * (nz + 1))
            + 2 * nz * ((nx + 1) * ny + nx * (ny + 1)))
    cells = 8 * nodes
    etas = tasks if stacked else 1
    scales = tasks if tasks > 1 and not stacked else 0
    nbytes = (item * (tasks * (read + 2 * 6 * nodes) + 3 * etas * cells
                      + scales)
              + ritem * (cells + sum(shape)))
    return nbytes, tasks * GS_FLOPS_PER_NODE * nodes


def line_phase_work(shape, color, axis, item, ritem, tasks=1,
                    stacked=False):
    """(bytes, flops, scratch bytes) of one line phase of parity
    ``color`` along ``axis``.

    In the frame of the lines (x along the line): the neighbouring edges
    the lines read, the 5 NX - 4 unknowns per line written and their
    sources read, the cells around the lines (3 eta, zeta) and the
    widths, once each.  The scratch is returned apart.  ``tasks`` and
    ``stacked``: as in :func:`gs_phase_work`.
    """
    NX, NY, NZ = (shape[i] for i in FRAMES[axis])
    ncy, ncz = (NY - color[0]) // 2, (NZ - color[1]) // 2
    lines = ncy * ncz
    written = lines * (5 * NX - 4)
    read = (NX * ((ncy + 1) * ncz + ncy * (ncz + 1))
            + (NX - 1) * 2 * ncy * (ncz + 1)
            + (NX - 1) * (ncy + 1) * 2 * ncz)
    cells = NX * 2 * ncy * 2 * ncz
    etas = tasks if stacked else 1
    scales = tasks if tasks > 1 and not stacked else 0
    nbytes = (item * (tasks * (read + 2 * written) + 3 * etas * cells
                      + scales)
              + ritem * (cells + NX + NY + NZ))
    scratch = 2 * item * SCRATCH_VALUES * lines * (NX - 1)
    return nbytes, tasks * LINE_FLOPS_PER_GROUP * lines * NX, tasks * scratch
