"""Tensor meshes and automatic, skin-depth-driven mesh construction.

Copy of ``emg3d_tpu.meshes`` for the PyTorch port (numpy only; the text
below speaks of the JAX package it was written for).
Rebuild of the reference's emg3d/meshes.py.  Everything in this
module is host-side numpy: grids are *static metadata* for the JAX/XLA
compute path (shapes must be known at trace time), so there is no benefit in
tracing any of it.  The mesh object is hashable so it can be used as a static
argument to jitted functions.

Reference behaviour (cited emsig/emg3d files):
- BaseMesh/TensorMesh: emg3d/meshes.py:42-232
- construct_mesh/origin_and_widths: emg3d/meshes.py:235-849
- _stretch/_seasurface: emg3d/meshes.py:852-1081
- good_mg_cell_nr/skin_depth/wavelength/cell_width: emg3d/meshes.py:1084-1274
- check_mesh: emg3d/meshes.py:1277-1304
"""

import warnings
from copy import deepcopy

import numpy as np
import scipy as sp

from emg3d_tpu_torch import utils

__all__ = [
    "TensorMesh", "BaseMesh", "construct_mesh", "origin_and_widths",
    "good_mg_cell_nr", "skin_depth", "wavelength", "cell_width", "check_mesh",
    "estimate_gridding_opts", "pad_mesh_cells", "snap_shapes",
]


def __dir__():
    return __all__


class BaseMesh:
    """Minimal 3-D tensor mesh: cell widths plus origin.

    Provides node/center coordinates and the shapes/counts of cells, edges,
    and faces of a staggered (Yee) grid (reference: emg3d/meshes.py:42-130).

    Parameters
    ----------
    h : [array_like, array_like, array_like]
        Cell widths in x, y, and z directions.
    origin : array_like
        Origin (x, y, z).
    """

    def __init__(self, h, origin, **kwargs):
        self.origin = np.array(origin, dtype=np.float64)
        self.h = [np.array(h[0], dtype=np.float64, ndmin=1),
                  np.array(h[1], dtype=np.float64, ndmin=1),
                  np.array(h[2], dtype=np.float64, ndmin=1)]

        # Nodes.
        self.shape_nodes = tuple(hh.size + 1 for hh in self.h)
        self.nodes_x = np.r_[0.0, self.h[0].cumsum()] + self.origin[0]
        self.nodes_y = np.r_[0.0, self.h[1].cumsum()] + self.origin[1]
        self.nodes_z = np.r_[0.0, self.h[2].cumsum()] + self.origin[2]

        # Cells.
        self.shape_cells = tuple(hh.size for hh in self.h)
        self.n_cells = int(np.prod(self.shape_cells))
        self.cell_centers_x = (self.nodes_x[1:] + self.nodes_x[:-1]) / 2
        self.cell_centers_y = (self.nodes_y[1:] + self.nodes_y[:-1]) / 2
        self.cell_centers_z = (self.nodes_z[1:] + self.nodes_z[:-1]) / 2

        nc, nn = self.shape_cells, self.shape_nodes

        # Edges.
        self.shape_edges_x = (nc[0], nn[1], nn[2])
        self.shape_edges_y = (nn[0], nc[1], nn[2])
        self.shape_edges_z = (nn[0], nn[1], nc[2])
        self.n_edges_x = int(np.prod(self.shape_edges_x))
        self.n_edges_y = int(np.prod(self.shape_edges_y))
        self.n_edges_z = int(np.prod(self.shape_edges_z))
        self.n_edges = self.n_edges_x + self.n_edges_y + self.n_edges_z

        # Faces.
        self.shape_faces_x = (nn[0], nc[1], nc[2])
        self.shape_faces_y = (nc[0], nn[1], nc[2])
        self.shape_faces_z = (nc[0], nc[1], nn[2])
        self.n_faces_x = int(np.prod(self.shape_faces_x))
        self.n_faces_y = int(np.prod(self.shape_faces_y))
        self.n_faces_z = int(np.prod(self.shape_faces_z))
        self.n_faces = self.n_faces_x + self.n_faces_y + self.n_faces_z

    def __repr__(self):
        return (f"TensorMesh: {self.shape_cells[0]} x {self.shape_cells[1]} x "
                f"{self.shape_cells[2]} ({self.n_cells:,})")

    @property
    def cell_volumes(self):
        """Cell volumes as 1-D array (Fortran-raveled, like the reference)."""
        if getattr(self, "_cell_volumes", None) is None:
            self._cell_volumes = self.cell_volumes_3d.ravel(order="F")
        return self._cell_volumes

    @property
    def cell_volumes_3d(self):
        """Cell volumes as (nx, ny, nz) array — natural for the TPU path."""
        if getattr(self, "_cell_volumes_3d", None) is None:
            self._cell_volumes_3d = (
                self.h[0][:, None, None]
                * self.h[1][None, :, None]
                * self.h[2][None, None, :]
            )
        return self._cell_volumes_3d


@utils._known_class
class TensorMesh(BaseMesh):
    """Tensor mesh with comparison, copy, hashing, and (de)serialization.

    Same container as the reference's TensorMesh (emg3d/meshes.py:134-232),
    minus the discretize subclassing (plotting etc. is not a solver concern).
    Hashable so it can serve as a static argument under ``jax.jit``.
    """

    def __eq__(self, mesh):
        equal = hasattr(mesh, "shape_cells") and hasattr(mesh, "h")
        if equal:
            equal = len(mesh.shape_cells) == len(self.shape_cells)
        if equal:
            equal = bool(np.all(np.array(self.shape_cells)
                                == np.array(mesh.shape_cells)))
        if equal:
            equal = (np.allclose(self.h[0], mesh.h[0], atol=0)
                     and np.allclose(self.h[1], mesh.h[1], atol=0)
                     and np.allclose(self.h[2], mesh.h[2], atol=0)
                     and np.allclose(self.origin, mesh.origin, atol=0))
        return bool(equal)

    def __hash__(self):
        if getattr(self, "_hash", None) is None:
            self._hash = hash((
                self.shape_cells,
                self.h[0].tobytes(), self.h[1].tobytes(),
                self.h[2].tobytes(), self.origin.tobytes(),
            ))
        return self._hash

    def copy(self):
        """Return a copy of the TensorMesh."""
        return self.from_dict(self.to_dict(True))

    def to_dict(self, copy=False):
        """Store the necessary information in a dict for serialization."""
        out = {
            "hx": self.h[0], "hy": self.h[1], "hz": self.h[2],
            "origin": self.origin, "__class__": self.__class__.__name__,
        }
        return deepcopy(out) if copy else out

    @classmethod
    def from_dict(cls, inp):
        """Create a TensorMesh from a dict as given by ``to_dict``."""
        inp = {k: v for k, v in inp.items() if k != "__class__"}
        return cls(h=[inp.pop("hx"), inp.pop("hy"), inp.pop("hz")], **inp)


# -------------------------------------------------------------------------
# Automatic mesh construction (host-side; reference meshes.py:235-849).
# -------------------------------------------------------------------------

def construct_mesh(frequency, properties, center, domain=None, vector=None,
                   seasurface=None, **kwargs):
    """Return a TensorMesh for the given survey parameters.

    Frequency- and property-driven automatic gridding: minimum cell width
    from skin depth and points-per-skin-depth; buffer of one wavelength
    (capped by ``max_buffer``) around the survey domain; cell numbers
    restricted to multigrid-friendly values.  See the reference docstring
    (emg3d/meshes.py:235-494) for the parameter description — the accepted
    parameters and semantics are identical.
    """
    kwargs = deepcopy(kwargs)
    verb = kwargs.get("verb", 0)

    kwargs["frequency"] = frequency
    kwargs["verb"] = -1
    kwargs["raise_error"] = False
    params = [
        {"center": center[0]},
        {"center": center[1]},
        {"center": center[2], "seasurface": seasurface},
    ]

    # Distribute properties onto directions (emg3d/meshes.py:507-522).
    if isinstance(properties, (int, float)):
        properties = np.array([properties])
    if len(properties) == 3:
        p = properties
        params[0]["properties"] = [p[0], p[2], p[2]]
        params[1]["properties"] = [p[0], p[2], p[2]]
        params[2]["properties"] = [p[0], p[1], p[2]]
    elif len(properties) == 4:
        p = properties
        params[0]["properties"] = [p[0], p[1], p[1]]
        params[1]["properties"] = [p[0], p[1], p[1]]
        params[2]["properties"] = [p[0], p[2], p[3]]
    elif len(properties) == 7:
        p = properties
        params[0]["properties"] = [p[0], p[1], p[2]]
        params[1]["properties"] = [p[0], p[3], p[4]]
        params[2]["properties"] = [p[0], p[5], p[6]]
    else:
        kwargs["properties"] = properties

    def _distribute(value, name):
        """Put direction-specific values into the per-direction dicts."""
        if isinstance(value, dict):
            value = (value["x"], value["y"], value["z"])
        for i, data in enumerate(params):
            if value[i] is not None:
                data[name] = value[i]

    for name, value in zip(["domain", "vector"], [domain, vector]):
        if value is None or isinstance(value, np.ndarray):
            kwargs[name] = value
        elif isinstance(value, dict) or len(value) == 3:
            _distribute(value, name)
        else:
            kwargs[name] = value

    for name in ["distance", "stretching", "min_width_limits",
                 "min_width_pps", "center_on_edge"]:
        value = kwargs.pop(name, None)
        if value is not None:
            if isinstance(value, bool):
                kwargs[name] = value
            elif isinstance(value, (int, float)):
                kwargs[name] = np.array([value])
            elif isinstance(value, dict) or len(value) == 3:
                _distribute(value, name)
            else:
                kwargs[name] = value

    out = [origin_and_widths(**kwargs, **p) for p in params]
    if any(o[0] is None for o in out):
        raise RuntimeError("No suitable grid found; relax your criteria.")

    mesh = TensorMesh(h=[o[1] for o in out],
                      origin=np.array([o[0] for o in out]))

    info = (f"\n         == GRIDDING IN X ==\n{out[0][2]}\n"
            f"\n         == GRIDDING IN Y ==\n{out[1][2]}\n"
            f"\n         == GRIDDING IN Z ==\n{out[2][2]}\n")
    mesh.construct_mesh_info = info
    if verb > 0:
        print(info)

    return mesh


def origin_and_widths(frequency, properties, center, domain=None, vector=None,
                      seasurface=None, **kwargs):
    """Return origin and cell widths for one direction.

    1-D gridding search over good cell numbers × survey-domain stretching ×
    buffer stretching until both domains are covered (reference:
    emg3d/meshes.py:582-849).
    """
    from emg3d_tpu_torch import maps  # Avoid circular import.

    distance = kwargs.pop("distance", None)
    stretching = kwargs.pop("stretching", [1.0, 1.5])
    min_width_limits = kwargs.pop("min_width_limits", None)
    min_width_pps = kwargs.pop("min_width_pps", 3)
    lambda_factor = kwargs.pop("lambda_factor", 1.0)
    max_buffer = kwargs.pop("max_buffer", 100000)
    lambda_from_center = kwargs.pop("lambda_from_center", False)
    pmap = kwargs.pop("mapping", "Resistivity")
    cell_numbers = kwargs.pop("cell_numbers", good_mg_cell_nr())
    center_on_edge = kwargs.pop("center_on_edge", "notset")
    raise_error = kwargs.pop("raise_error", True)
    verb = kwargs.pop("verb", 0)

    if kwargs:
        raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}.")

    if center_on_edge == "notset":
        center_on_edge = True

    if isinstance(pmap, str):
        pmap = getattr(maps, "Map" + pmap)()

    # Conductivities for [min-width, buffer-left, buffer-right].
    cond = pmap.backward(np.array(properties, ndmin=1, dtype=float))
    cond_arr = np.array([cond[0], cond[min(cond.size - 1, 1)],
                         cond[min(cond.size - 1, 2)]])
    skind = skin_depth(frequency, cond_arr)
    dmin = cell_width(skind[0], min_width_pps, min_width_limits)

    # Survey domain; priority: domain > distance > vector.
    if domain is not None:
        domain = np.array(domain, dtype=np.float64)
    elif distance is not None:
        domain = np.array([center - abs(distance[0]),
                           center + abs(distance[1])])
    elif vector is not None:
        domain = np.array([vector.min(), vector.max()], dtype=float)
    else:
        raise ValueError(
            "At least one of `domain`/`distance`/`vector` must be provided."
        )

    # Trim a provided vector to the domain (keeping one node beyond
    # each edge); a vector too short after trimming is discarded.
    if vector is not None:
        below = np.flatnonzero(vector <= domain[0])
        if below.size > 1:
            vector = vector[below[-1]:]
        above = np.flatnonzero(vector >= domain[1])
        if above.size > 1:
            vector = vector[:above[1]]
        if vector.size < 3:
            vector = None

    if seasurface is not None:
        if seasurface <= center:
            raise ValueError("The `seasurface` must be bigger than `center`.")
        domain[1] = max(domain[1], seasurface)

    if vector is None and center_on_edge:
        vector = np.r_[center - dmin, center, center + dmin]

    # Core segment of the grid (the part that is never stretched).
    if vector is None:
        core = _Segment(center - dmin / 2, center + dmin / 2,
                        np.atleast_1d(dmin))
        had_vector = None
    else:
        core = _Segment(vector[0], vector[-1], np.diff(vector))
        had_vector = vector

    if seasurface is not None:
        core = _snap_seasurface(core, center, seasurface, stretching,
                                had_vector, min_width_limits)

    # Computational domain: one wavelength buffer (capped).
    wlength = lambda_factor * wavelength(skind[1:])
    if lambda_from_center:
        in_domain = abs(domain - center)
        d_buff = np.max([np.zeros(2), (2 * wlength - in_domain) / 2], axis=0)
        comp_domain = np.array([domain[0] - d_buff[0], domain[1] + d_buff[1]])
        comp_domain[0] = max(comp_domain[0], center - max_buffer)
        comp_domain[1] = min(comp_domain[1], center + max_buffer)
    else:
        dbuffer = np.min([wlength, np.ones(2) * max_buffer], axis=0)
        comp_domain = np.array([domain[0] - dbuffer[0],
                                domain[1] + dbuffer[1]])

    found = _search_discretization(core, np.unique(cell_numbers),
                                   stretching, domain, comp_domain)

    if found is None:
        msg = "No suitable grid found; relax your criteria."
        if raise_error:
            raise RuntimeError(msg)
        x0, hx, info = None, None, msg
    else:
        x0 = found.full.lo
        hx = found.full.widths
        info = _gridding_report(found, skind, cond.size, domain,
                                comp_domain)

    if verb > 0:
        print(info)

    if verb < 0:
        return x0, hx, info
    return x0, hx


class _Segment:
    """A contiguous run of cells: [lo, hi] with its widths."""

    def __init__(self, lo, hi, widths, leftover=0):
        self.lo = float(lo)
        self.hi = float(hi)
        self.widths = np.atleast_1d(np.asarray(widths, dtype=float))
        self.leftover = leftover    # unused cells of the budget

    @property
    def nodes(self):
        return self.lo + np.r_[0.0, np.cumsum(self.widths)]


class _Candidate:
    """Accepted discretization: search coordinates + both segments."""

    def __init__(self, n_cells, alpha_survey, alpha_comp, survey, full):
        self.n_cells = n_cells
        self.alpha_survey = alpha_survey
        self.alpha_comp = alpha_comp
        self.survey = survey
        self.full = full


def _side_cells(gap, seed_width, alpha, budget):
    """Geometric extension covering ``gap``: (n or None, width series).

    The series continues the segment's edge width with ratio ``alpha``;
    ``n`` is the smallest count whose cumulative span reaches ``gap``
    (None if even ``budget`` cells fall short).
    """
    series = seed_width * alpha ** np.arange(1, budget + 1)
    if gap <= 0:
        return 0, series
    n = int(np.searchsorted(np.cumsum(series), gap, side='left')) + 1
    return (None if n > budget else n), series


def _grow(segment, alpha, n_cells, domain, spend_leftover=False):
    """Extend ``segment`` to cover ``domain`` within an ``n_cells`` budget.

    Returns the grown :class:`_Segment` or None if the budget/stretching
    cannot cover the domain.  With ``spend_leftover`` the remaining
    budget is split between the two sides (domain over-coverage instead
    of unused cells).
    """
    w = segment.widths
    nl, left = _side_cells(segment.lo - domain[0], w[0], alpha, n_cells)
    nr, right = _side_cells(domain[1] - segment.hi, w[-1], alpha, n_cells)
    if nl is None or nr is None:
        return None
    leftover = n_cells - w.size - nl - nr
    if leftover < 0:
        return None
    if spend_leftover:
        nl += leftover // 2
        nr += leftover - leftover // 2
        leftover = 0
    return _Segment(segment.lo - left[:nl].sum(),
                    segment.hi + right[:nr].sum(),
                    np.r_[left[:nl][::-1], w, right[:nr]],
                    leftover=leftover)


def _alpha_ladder(lo, hi):
    """Candidate stretching factors, finest-first (≈0.001 steps, ≤100)."""
    n = max(1, min(100, int((hi - lo) / 0.001)))
    return np.linspace(lo, hi, n)


def _search_discretization(core, cell_numbers, stretching, domain,
                           comp_domain):
    """First (cell count, survey α, buffer α) covering both domains.

    Smallest-first over MG-friendly cell counts; at each count the
    survey domain is covered with the least stretching that fits, then
    the buffer with the least stretching ≥ the survey's.  Returns a
    :class:`_Candidate` or None.
    """
    for n_cells in cell_numbers:
        for a_s in _alpha_ladder(1.0, stretching[0]):
            survey = _grow(core, a_s, n_cells, domain)
            if survey is None:
                continue
            for a_c in _alpha_ladder(a_s, stretching[1]):
                full = _grow(survey, a_c, n_cells, comp_domain,
                             spend_leftover=True)
                if full is not None:
                    return _Candidate(int(n_cells), a_s, a_c, survey,
                                      full)
    return None


def _gridding_report(found, skind, n_props, domain, comp_domain):
    """Human-readable summary of an accepted discretization."""
    hxs, hx = found.survey.widths, found.full.widths
    ratios = hxs[1:] / hxs[:-1]
    alpha_eff = np.max(np.r_[1.0, ratios, 1.0 / ratios])
    prec = int(np.ceil(max(0, -np.log10(hx.min()) + 1)))

    def rng(lo, hi):
        return f"{lo:.{prec}f} - {hi:.{prec}f}"

    depths = " / ".join(f"{s:.{prec}f}" for s in skind[:n_props])
    n_buffer = found.n_cells - hxs.size - found.full.leftover
    return (
        f"Skin depth     [m] : {depths}  [corr. to `properties`]\n"
        f"Survey dom. DS [m] : {rng(*domain)}\n"
        f"Comp. dom. DC  [m] : {rng(*comp_domain)}\n"
        f"Final extent   [m] : {rng(found.full.lo, found.full.hi)}\n"
        f"Cell widths    [m] : {hxs.min():.{prec}f} / "
        f"{hxs.max():.{prec}f} / {hx.max():.{prec}f}"
        "  [min(DS) / max(DS) / max(DC)]\n"
        f"Number of cells    : {found.n_cells} ({hxs.size} / {n_buffer} "
        f"/ {found.full.leftover})  [Total (DS/DC/remain)]\n"
        f"Max stretching     : {found.alpha_survey:.3f} "
        f"({alpha_eff:.3f}) / {found.alpha_comp:.3f}"
        "  [DS (seasurface) / DC]")


def _snap_seasurface(core, center, seasurface, stretching, vector, limits):
    """Rebuild the core segment so the seasurface lands on a node.

    Two strategies (reference behavior, emg3d/meshes.py:944-1081):
    shift a single-cell core when the surface is within half a cell;
    otherwise append a geometrically-growing column of cells from the
    core top to the surface, scanning a small ladder of base-width
    scalings until the implied growth factor is acceptable.
    """
    widths = core.widths
    lo, hi = core.lo, core.hi

    if vector is None and widths.size == 1 and (
            abs(seasurface - hi) <= widths / 2):
        shift = seasurface - hi
        return _Segment(lo + shift, hi + shift, widths)

    out = None
    for scale in _base_width_scales(vector, limits, widths):
        if vector is None:
            base = scale * widths.item()
            top = center + base / 2
            alpha_cap = 1.1 * stretching[0]
        else:
            base = widths[-1]
            top = hi
            alpha_cap = 1.25 * stretching[0]

        column = _geometric_column(seasurface - top, base,
                                   min(alpha_cap, stretching[1]))
        if column is None:
            continue

        if vector is None:
            new_widths = np.r_[base, column]
            new_lo = center - base / 2
        else:
            new_widths = np.r_[widths, column]
            new_lo = lo
        out = _Segment(new_lo, new_lo + new_widths.sum(), new_widths)
        break

    if out is None:
        out = _Segment(lo, hi, widths)
    if not np.isclose(0.0, np.min(abs(out.nodes - seasurface))):
        warnings.warn(
            "emg3d_tpu_torch: Seasurface is not at an actual boundary; "
            "relax your criteria.", UserWarning)
    return out


def _base_width_scales(vector, limits, widths):
    """Base-width scaling candidates for the seasurface column.

    With a user vector or a fixed width limit the base is not free
    ([1.0]); otherwise a 13-point ladder over [0.7, 1.3] (clipped by
    the width limits), ordered by closeness to 1 with 1.0 first.
    """
    n_limits = 0 if limits is None else np.array(limits, ndmin=1).size
    if vector is not None or n_limits == 1:
        return [1.0]
    f_lo, f_hi = 0.7, 1.3
    if n_limits == 2:
        rel = np.asarray(limits) / widths
        f_lo, f_hi = max(f_lo, rel[0]), min(f_hi, rel[1])
    ladder = np.linspace(f_lo, f_hi, 13)
    ladder = ladder[np.argsort(abs(ladder - 1))]
    if ladder[0] != 1.0:
        ladder = np.r_[1.0, ladder]
    return ladder


def _geometric_column(delta, base, alpha_max):
    """Widths of a geometric column spanning exactly ``delta``.

    Chooses ``n = floor(delta/base)`` cells and solves for the growth
    factor α with Σ base·αⁱ = delta (brentq in [0.5, 10]); None when no
    cell fits or the required α exceeds ``alpha_max``.
    """
    n = int(np.floor(delta / base))
    if n < 1:
        return None
    powers = np.arange(1, n + 1)
    alpha = sp.optimize.brentq(
        lambda a: base * np.sum(a ** powers) - delta, 0.5, 10.0)
    if alpha >= alpha_max:
        return None
    return base * alpha ** powers


def good_mg_cell_nr(max_nr=1024, max_lowest=5, min_div=3):
    """Return multigrid-friendly cell numbers p*2^n, p<=max_lowest, n>=min_div.

    Reference: emg3d/meshes.py:1084-1144.
    """
    lowest = np.array([2, 3, 5, 7, 9, 11, 13, 15, 17, 19], dtype=np.int64)
    if max_lowest > lowest[-1]:
        raise ValueError(
            f"Maximum lowest is {max_lowest}, please use a value < 20.")
    lowest = lowest[lowest <= max_lowest]
    numbers = np.unique(lowest[:, None] * 2 ** np.arange(min_div, 30))
    return numbers[numbers <= max_nr]


def pad_mesh_cells(mesh, shape, alpha=1.3):
    """Grow ``mesh`` outward to ``shape`` cells per dimension.

    TPU-native cold-start control (no reference equivalent — the
    reference's numba kernels are shape-generic, reference
    emg3d/core.py:43, while XLA compiles one executable set per grid
    SHAPE): padding several automatically-constructed grids to a shared
    shape lets them reuse one compiled multigrid hierarchy.

    The extra cells are split between both ends of each axis and
    continue the edge cell width geometrically with ratio ``alpha`` —
    the domain only grows outward, so boundary conditions only improve;
    all interior nodes (sources, receivers, survey domain) are
    untouched.
    """
    shape = tuple(int(n) for n in shape)
    h_new, origin_new = [], []
    for d in range(3):
        h = np.asarray(mesh.h[d], dtype=np.float64)
        extra = shape[d] - h.size
        if extra < 0:
            raise ValueError(
                f"Target shape {shape} smaller than mesh "
                f"{mesh.shape_cells} in dimension {d}.")
        nl = extra // 2
        nr = extra - nl
        left = h[0] * alpha ** np.arange(1, nl + 1)
        right = h[-1] * alpha ** np.arange(1, nr + 1)
        h_new.append(np.r_[left[::-1], h, right])
        origin_new.append(mesh.origin[d] - left.sum())
    return TensorMesh(h_new, origin=np.array(origin_new))


def snap_shapes(shapes, max_growth=1.35):
    """Map each cell-count shape to a shared shape class.

    Per-dimension greedy clustering from the largest value down: a
    dimension value joins the current class while the class
    representative exceeds it by at most ``max_growth``; the class
    representatives are existing values, so padded shapes stay within
    the multigrid-friendly set the gridding search chose from
    (:func:`good_mg_cell_nr`).  Returns ``{shape: class_shape}``.

    Used by the Simulation layer (``shape_classes=True``) to bound the
    number of compiled hierarchies of a multi-grid-shape survey.
    """
    shapes = [tuple(int(n) for n in s) for s in shapes]
    reps = []
    for d in range(3):
        rep_of, rep = {}, None
        for v in sorted({s[d] for s in shapes}, reverse=True):
            if rep is None or rep > v * max_growth:
                rep = v
            rep_of[v] = rep
        reps.append(rep_of)
    return {s: tuple(reps[d][s[d]] for d in range(3)) for s in set(shapes)}


def skin_depth(frequency, conductivity, mu_r=1.0):
    """Skin depth delta = 1/sqrt(pi f sigma mu); Laplace variant for f<0.

    Reference: emg3d/meshes.py:1147-1187.
    """
    mu = mu_r * sp.constants.mu_0
    out = 1 / np.sqrt(np.pi * abs(frequency) * conductivity * mu)
    if frequency < 0:  # Laplace domain.
        out /= np.sqrt(2 * np.pi)
    return out


def wavelength(skin_depth):
    """Wavelength lambda = 2 pi delta (emg3d/meshes.py:1190-1216)."""
    return 2 * np.pi * skin_depth


def cell_width(skin_depth, pps=3, limits=None):
    """Cell width = skin_depth/pps, optionally clipped to limits.

    Reference: emg3d/meshes.py:1219-1274.
    """
    width = skin_depth / pps
    if limits is not None:
        limits = np.array(limits, ndmin=1)
        if limits.size == 1:
            width = limits
        else:
            width = np.clip(width, *limits)
    return width


def check_mesh(mesh):
    """Warn if the mesh dimensions are not multigrid-friendly.

    Reference: emg3d/meshes.py:1277-1304.
    """
    good = good_mg_cell_nr(max_nr=50000, max_lowest=5, min_div=3)

    # Ensure mesh is a TensorMesh.
    if not hasattr(mesh, "shape_cells"):
        raise TypeError("Mesh must be a TensorMesh instance.")

    # Check mesh dimensions, warn if not optimal.
    if any(n not in good for n in mesh.shape_cells):
        msg = (
            f"emg3d_tpu_torch: Mesh dimension {mesh.shape_cells} is not optimal "
            "for MG solver. Good numbers are:\n"
            f"{good_mg_cell_nr(max_nr=5000, max_lowest=5, min_div=3)}"
        )
        warnings.warn(msg, UserWarning)


def estimate_gridding_opts(gridding_opts, model, survey, input_sc2=None):
    """Estimate missing parameters of ``gridding_opts`` from survey and model.

    Fills frequency (log-mean of survey frequencies), properties (minimum
    conductivity on each boundary face and at the source center), center
    (mean source center), and domain (source/receiver extent with 10 %
    margin and aspect clamps), mirroring emg3d/meshes.py:1307-1567.
    """
    from emg3d_tpu_torch import maps as _maps

    gridding_opts = deepcopy(gridding_opts)

    # Optional values that we only include if provided.
    verb = gridding_opts.pop("verb", 0)

    # Handle expand-related parameters (deprecated in reference too).
    expand = gridding_opts.pop("expand", None)

    # Get the mapping.
    mapping = gridding_opts.pop("mapping", model.map.name)
    if not isinstance(mapping, str):
        mapping = mapping.name
    pmap = getattr(_maps, "Map" + mapping)()

    # Frequency: log-average of all survey frequencies
    # (reference meshes.py:1422).
    frequency = gridding_opts.pop(
        "frequency",
        float(10 ** np.mean(np.log10(
            np.array([f for f in survey.frequencies.values()])))),
    )

    # Center: mean of all source centers (reference meshes.py:1445-1450).
    src_centers = np.array(
        [s.center for s in survey.sources.values()])
    center = gridding_opts.pop("center", tuple(src_centers.mean(0)))

    # Vector/distance/domain handling.
    vector = gridding_opts.pop("vector", None)
    if isinstance(vector, str):
        # 'xyz' string: take the model grid vectors for given directions.
        vector = (
            model.grid.nodes_x if "x" in vector.lower() else None,
            model.grid.nodes_y if "y" in vector.lower() else None,
            model.grid.nodes_z if "z" in vector.lower() else None,
        )
    distance = gridding_opts.pop("distance", None)
    domain = gridding_opts.pop("domain", None)

    def _initiate_dict(value):
        if value is None:
            return {"x": None, "y": None, "z": None}
        if isinstance(value, dict):
            return {k: value.get(k, None) for k in "xyz"}
        if len(value) == 3:
            return {"x": value[0], "y": value[1], "z": value[2]}
        return {"x": value, "y": value, "z": value}

    domain = _initiate_dict(domain)
    distance = _initiate_dict(distance)
    vector = _initiate_dict(vector)

    # Electrode positions define the default domain.
    points = [np.array([s.center for s in survey.sources.values()])]
    for r in survey.receivers.values():
        off = np.zeros(3)
        if getattr(r, "relative", False):
            # Relative receivers: offsets from each source.
            for s in survey.sources.values():
                points.append(np.atleast_2d(np.asarray(s.center) +
                                            np.asarray(r.center)))
            continue
        points.append(np.atleast_2d(np.asarray(r.center) + off))
    points = np.concatenate(points, axis=0)

    for i, key in enumerate("xyz"):
        if domain[key] is None and distance[key] is None \
                and vector[key] is None:
            pmin, pmax = points[:, i].min(), points[:, i].max()
            diff = max(100.0, (pmax - pmin) * 0.1)
            dim = [pmin - diff, pmax + diff]
            if key == "z":
                # Ensure at least some depth extent below.
                dim = [pmin - max(1000.0, (pmax - pmin) * 2), pmax + diff]
            domain[key] = dim

    # Properties: if not provided, use min conductivity at boundaries and
    # at source center (simplified variant of reference meshes.py:1464-1492).
    properties = gridding_opts.pop("properties", None)
    if properties is None:
        cond = pmap.backward(model.property_x)

        def repr_prop(c):
            return float(pmap.forward(c))

        # Source center cell.
        def _idx(nodes, coo):
            return int(np.clip(np.searchsorted(nodes, coo) - 1, 0,
                               nodes.size - 2))

        six = _idx(model.grid.nodes_x, center[0])
        siy = _idx(model.grid.nodes_y, center[1])
        siz = _idx(model.grid.nodes_z, center[2])
        p_src = repr_prop(cond[six, siy, siz])

        properties = [
            p_src,
            repr_prop(cond[0, :, :].min()),   # -x boundary
            repr_prop(cond[-1, :, :].min()),  # +x boundary
            repr_prop(cond[:, 0, :].min()),   # -y boundary
            repr_prop(cond[:, -1, :].min()),  # +y boundary
            repr_prop(cond[:, :, 0].min()),   # -z boundary
            repr_prop(cond[:, :, -1].min()),  # +z boundary
        ]

    gopts = {
        "frequency": frequency,
        "properties": properties,
        "center": center,
        "domain": domain,
        "mapping": mapping,
        "verb": verb,
        **gridding_opts,
    }
    if any(v is not None for v in vector.values()):
        gopts["vector"] = vector
    if any(v is not None for v in distance.values()):
        gopts["distance"] = distance
    if expand is not None:
        gopts["expand"] = expand

    return gopts
