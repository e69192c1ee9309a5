"""Domain-decomposed (grid-sharded) solves over a list of devices.

Port of ``emg3d_tpu.parallel.domain``.  The JAX package shards one grid
over a 2-D ``Mesh`` and lets GSPMD insert the halo exchanges.  Here one
host loop drives every piece: a sharded level is a set of blocks, each a
sub-grid with a halo of ``HALO`` cells on a device of the mesh; every
level operation runs once per block, and copies between blocks take the
place of GSPMD's collective-permutes and all-gathers.

- The grid is sharded over its (y, z) axes on a (sy, sz) mesh
  (:func:`make_grid_mesh`); x stays whole on every device, so x-lines
  never cross a seam.
- A level stays sharded while ``ny // sy >= min_local`` and
  ``nz // sz >= min_local`` (:meth:`GridPlacement.spec`, the JAX rule);
  below that it is replicated: one copy on the mesh's first device
  (the JAX package keeps one on every device, where each runs the same
  coarse solve; in one host loop that would be the same launches n
  times).
- Every seam lies at a cell index that stays even down every sharded
  level (a coarse seam is the fine seam / 2), and every block's extent
  starts at an even index.  So a block's local parities equal the global
  ones, and the 8-color and 4-color phases, restriction and prolongation
  run unchanged on each block.
- After every phase, every operator application and every transfer, the
  halos are refreshed from the blocks that own those entries
  (:func:`exchange_halos`).  A node on a seam is relaxed by both blocks,
  from the same values, so both compute the same update.
- Lines across a seam (y- and z-lines on a level sharded in y or z) are
  relaxed on a line layout of that level: the line axis whole, x split
  over the mesh axis it replaces (an all-to-all within each mesh column
  or row), and back after the smoothing call.
- Norms and dot products sum every entry once: over owned entries only.

A copy between two distinct CUDA devices is ``Tensor.copy_``, which runs
on the source device's current stream after an event of the
destination's current stream and makes the destination's stream wait on
an event of the copy (ATen's device-to-device copy): the kernels that
produced and read the entries are ordered without a host sync.

The module imports nothing of ``emg3d_tpu``.
"""

import numpy as np
import torch

from emg3d_tpu_torch import config
from emg3d_tpu_torch.ops import operator, smoothers, transfer

__all__ = ["DeviceGrid", "make_grid_mesh", "GridPlacement", "Layout",
           "Pieces", "ShardedLevel", "place_field", "gather_field",
           "exchange_halos", "HALO"]

# Halo width in cells.  Two, so that every block's extent starts at an
# even cell index (the seams are even) and the restriction of a block
# covers its coarse block's owned entries.
HALO = 2

# Cell (True) or node (False) per axis, of the edge components and of
# cell arrays.
EX, EY, EZ = (True, False, False), (False, True, False), (False, False, True)
CELL = (True, True, True)
EDGES = (EX, EY, EZ)


# ==========================================================================
# Device meshes.
# ==========================================================================

def _device(d):
    """``d`` as a ``torch.device`` with an index for CUDA; raises on a
    device that is neither the CPU nor a CUDA card of this host."""
    d = torch.device(d)
    if d.type not in ("cpu", "cuda"):
        raise ValueError(f"Unsupported device {d}; expected cpu or cuda.")
    config.resolve_device(d)
    if d.type == "cuda":
        index = torch.cuda.current_device() if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"No CUDA device {d} on this host.")
        d = torch.device("cuda", index)
    return d


def device_list(n_devices=None, devices=None):
    """The devices of a mesh: ``devices`` (default: every CUDA card; no
    card raises), the first ``n_devices`` of them.  A device may repeat;
    all must be of one type."""
    if devices is None:
        config.resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(
                f"n_devices={n_devices}, but {len(devs)} device(s) given.")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("A mesh needs at least one device.")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"A mesh takes devices of one type; got {devs}.")
    return devs


class DeviceGrid:
    """A mesh of ``torch.device`` entries: the port's ``jax.sharding.Mesh``.

    ``devices`` is a numpy object array of ``torch.device`` (an entry may
    repeat a device: several pieces on one card), ``axis_names`` names its
    axes.
    """

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-D devices for axis names {axis_names}.")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return self.devices.shape


def make_grid_mesh(n_devices=None, devices=None, axes=("gy", "gz")):
    """A 2-D device mesh for grid sharding over the (y, z) axes.

    Factors the number of devices as close to square as possible (8 ->
    (4, 2), 4 -> (2, 2), 2 -> (2, 1)), as ``emg3d_tpu``'s
    ``make_grid_mesh`` does.  ``devices``: a list of devices (an entry
    may repeat, e.g. ``['cuda:0'] * 4``); default every CUDA card, and
    without one it raises.
    """
    devs = device_list(n_devices, devices)
    n = len(devs)
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return DeviceGrid(grid.reshape(n // a, a), axes)


# ==========================================================================
# Layouts: blocks of one level's grid, and copies between them.
# ==========================================================================

def _even_cuts(n, parts, q):
    """Seams of ``parts`` owned ranges over ``n`` cells, every inner seam
    a multiple of ``q``, as even as possible."""
    cuts = [0] + [int(np.floor(k * n / parts / q + 0.5)) * q
                  for k in range(1, parts)] + [n]
    if any(b <= a for a, b in zip(cuts, cuts[1:])):
        raise ValueError(f"Cannot cut {n} cells into {parts} parts at "
                         f"multiples of {q}.")
    return cuts


class Layout:
    """Blocks of a grid of ``shape`` cells, each on a device.

    A block owns the cells ``own[i]`` = (lo, hi) per axis and holds the
    cells ``ext[i]`` = (a, b), its owned cells and halos.  Along an axis
    it owns the nodes lo .. hi-1, and node hi too where hi is the last
    node; it holds the nodes a .. b.  The owned ranges tile the grid.
    """

    def __init__(self, shape, blocks):
        self.shape = tuple(int(n) for n in shape)
        self.blocks = tuple(
            (torch.device(dev), tuple(map(tuple, own)),
             tuple(map(tuple, ext))) for dev, own, ext in blocks)
        self._hash = hash((self.shape, self.blocks))
        self._plans = {}

    def __eq__(self, other):
        return (isinstance(other, Layout) and self.shape == other.shape
                and self.blocks == other.blocks)

    def __hash__(self):
        return self._hash

    @classmethod
    def from_cuts(cls, shape, cuts, device_of, halo=HALO):
        """The layout of the product of per-axis ``cuts`` (lists of
        seams); ``device_of(i, j, k)`` is block (i, j, k)'s device."""
        blocks = []
        for idx in np.ndindex(*(len(c) - 1 for c in cuts)):
            own = tuple((c[i], c[i + 1]) for c, i in zip(cuts, idx))
            ext = tuple((max(lo - halo, 0), min(hi + halo, n))
                        for (lo, hi), n in zip(own, shape))
            blocks.append((device_of(*idx), own, ext))
        return cls(shape, blocks)

    @classmethod
    def single(cls, shape, device):
        """One block: the whole grid on ``device``."""
        whole = tuple((0, int(n)) for n in shape)
        return cls(shape, [(device, whole, whole)])

    def cuts(self, axis):
        """The seams along ``axis``."""
        return sorted({b[1][axis][0] for b in self.blocks}
                      | {self.shape[axis]})

    def split(self, axis):
        """Whether the blocks divide ``axis``."""
        return len(self.cuts(axis)) > 2

    def _range(self, block, kind, which):
        """Global index ranges of a block's owned or held entries of a
        component of ``kind``."""
        _, own, ext = self.blocks[block]
        out = []
        for ax, cell in enumerate(kind):
            lo, hi = own[ax] if which == "own" else ext[ax]
            if not cell and (which == "ext" or hi == self.shape[ax]):
                hi += 1
            out.append((lo, hi))
        return out

    def ext_shape(self, block, kind):
        return tuple(hi - lo for lo, hi in self._range(block, kind, "ext"))

    def ext_slices(self, block, kind):
        """Slices of a whole array of ``kind`` that a block holds."""
        return tuple(slice(lo, hi)
                     for lo, hi in self._range(block, kind, "ext"))

    def own_slices(self, block, kind):
        """Local slices of a block's owned entries of ``kind``."""
        ext = self._range(block, kind, "ext")
        return tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in
                     zip(self._range(block, kind, "own"), ext))

    def plan(self, dst, kind, halos_only=False):
        """Copies that fill ``dst``'s blocks from this layout's owned
        entries: [(src block, src slices, dst block, dst slices)].  With
        ``halos_only`` (``dst`` is this layout) a block takes nothing
        from itself: only its halos are filled.  The cache is keyed by
        ``dst``'s blocks, not by ``dst``: a layout that held another one
        (or itself) in its cache, and was held by it, would be a
        reference cycle."""
        key = (dst.shape, dst.blocks, kind, halos_only)
        if key not in self._plans:
            out = []
            for d in range(len(dst.blocks)):
                dext = dst._range(d, kind, "ext")
                for s in range(len(self.blocks)):
                    if halos_only and s == d:
                        continue
                    sown = self._range(s, kind, "own")
                    sext = self._range(s, kind, "ext")
                    box = [(max(a0, a1), min(b0, b1))
                           for (a0, b0), (a1, b1) in zip(sown, dext)]
                    if any(hi <= lo for lo, hi in box):
                        continue
                    out.append((
                        s, tuple(slice(lo - a, hi - a) for (lo, hi), (a, _)
                                 in zip(box, sext)),
                        d, tuple(slice(lo - a, hi - a) for (lo, hi), (a, _)
                                 in zip(box, dext))))
            self._plans[key] = tuple(out)
        return self._plans[key]

    def devices(self):
        return [b[0] for b in self.blocks]


class Pieces:
    """One component of a sharded field: a tensor per block of ``layout``.

    Elementwise arithmetic (``a + b``, ``a - b`` with pieces of the same
    layout or scalars, ``scalar * a``, ``a / scalar``), ``to(dtype)``,
    ``copy_``, ``cpu()`` (the whole array) and ``torch.zeros_like`` act
    block by block, so the solver's vector algebra runs on pieces as on
    tensors.  The halos stay equal to their owners' entries under
    elementwise operations.
    """

    __slots__ = ("parts", "layout", "kind")

    def __init__(self, parts, layout, kind):
        self.parts = list(parts)
        self.layout = layout
        self.kind = kind

    def _new(self, parts):
        return Pieces(parts, self.layout, self.kind)

    def _op(self, other, fn):
        if isinstance(other, Pieces):
            return self._new(fn(a, b) for a, b in zip(self.parts,
                                                       other.parts))
        return self._new(fn(a, other) for a in self.parts)

    def __add__(self, other):
        return self._op(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._op(other, lambda a, b: a - b)

    def __rmul__(self, other):
        return self._op(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._op(other, lambda a, b: a / b)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.zeros_like:
            p = args[0]
            return p._new(torch.zeros_like(a, **(kwargs or {}))
                          for a in p.parts)
        raise TypeError(f"{func.__name__} is not defined on Pieces.")

    @property
    def dtype(self):
        return self.parts[0].dtype

    def is_complex(self):
        return self.parts[0].is_complex()

    def to(self, dtype):
        return self._new(a.to(dtype) for a in self.parts)

    def copy_(self, other):
        for a, b in zip(self.parts, other.parts):
            a.copy_(b)
        return self

    def exchange(self):
        """Refresh every halo from the block that owns it, in place."""
        for s, ssl, d, dsl in self.layout.plan(self.layout, self.kind,
                                               halos_only=True):
            self.parts[d][dsl].copy_(self.parts[s][ssl])
        return self

    def relayout(self, dst):
        """These entries in the blocks of layout ``dst`` (halos filled)."""
        out = [torch.empty(dst.ext_shape(d, self.kind), dtype=self.dtype,
                           device=dev)
               for d, dev in enumerate(dst.devices())]
        for s, ssl, d, dsl in self.layout.plan(dst, self.kind):
            out[d][dsl].copy_(self.parts[s][ssl])
        return Pieces(out, dst, self.kind)

    def assign(self, other):
        """Fill these blocks (halos too) from ``other``'s owned entries,
        in place; ``other`` may be of another layout."""
        for s, ssl, d, dsl in other.layout.plan(self.layout, self.kind):
            self.parts[d][dsl].copy_(other.parts[s][ssl])
        return self

    def gather(self, device):
        """The whole array, on ``device``."""
        return self.relayout(Layout.single(self.layout.shape,
                                           device)).parts[0]

    def cpu(self):
        return self.gather(torch.device("cpu"))

    def owned(self):
        """The owned entries of every block (views)."""
        return [a[self.layout.own_slices(k, self.kind)]
                for k, a in enumerate(self.parts)]

    def vdot(self, other, device):
        """Sum over owned entries of conj(self) * other, a 0-d tensor on
        ``device``."""
        return sum(torch.vdot(a.reshape(-1), b.reshape(-1)).to(device)
                   for a, b in zip(self.owned(), other.owned()))

    def sqsum(self, device):
        """Sum over owned entries of |self|^2, a 0-d tensor on
        ``device``."""
        return sum(torch.sum(torch.abs(a) ** 2).to(device)
                   for a in self.owned())


def place_field(layout, arrays, dtype):
    """Host arrays (ex, ey, ez), or one array per ``kinds``, -> Pieces."""
    return tuple(_place(layout, a, kind, dtype)
                 for a, kind in zip(arrays, EDGES))


def _place(layout, a, kind, dtype):
    """One host (numpy) array or tensor of ``kind`` -> Pieces."""
    parts = []
    for k, dev in enumerate(layout.devices()):
        sl = a[layout.ext_slices(k, kind)]
        if isinstance(sl, np.ndarray):
            sl = torch.from_numpy(np.ascontiguousarray(sl))
        parts.append(sl.to(device=dev, dtype=dtype,
                           copy=True).contiguous())
    return Pieces(parts, layout, kind)


def gather_field(pieces, device):
    """Pieces (or tensors, returned as they are) -> whole tensors on
    ``device``, halos dropped."""
    return tuple(p.gather(device) if isinstance(p, Pieces) else p
                 for p in pieces)


def exchange_halos(pieces):
    """Refresh the halos of a tuple of Pieces, in place; returns it."""
    for p in pieces:
        p.exchange()
    return pieces


# ==========================================================================
# The placement plan.
# ==========================================================================

class GridPlacement:
    """Per-level sharding plan of the grids of one mesh.

    ``min_local``: keep a level sharded only while every device's local
    block is at least this many cells along each sharded axis, as in
    ``emg3d_tpu.parallel.domain.GridPlacement``; below that it is
    replicated, on the mesh's first device.
    """

    def __init__(self, mesh, min_local=4):
        if not isinstance(mesh, DeviceGrid) or len(mesh.shape) != 2:
            raise TypeError("GridPlacement takes a 2-D DeviceGrid "
                            "(make_grid_mesh).")
        self.mesh = mesh
        self.min_local = int(min_local)

    @property
    def device(self):
        """The mesh's first device: replicated levels and whole fields."""
        return self.mesh.devices.flat[0]

    def spec(self, shape_cells):
        """'sharded' or 'replicated' for a level of ``shape_cells`` (the
        JAX package's rule, from the mesh shape only)."""
        ny, nz = int(shape_cells[1]), int(shape_cells[2])
        sy, sz = self.mesh.shape
        if ny // sy >= self.min_local and nz // sz >= self.min_local:
            return "sharded"
        return "replicated"

    def _align(self, n, s):
        """The multiple of which every seam of an axis of ``n`` cells over
        ``s`` devices is: even on every level that can stay sharded.  A
        coarse seam is the fine seam / 2, and an axis coarsens at most
        while ``n`` is even and > 2, into a sharded level only while the
        coarse ``n // s`` >= min_local."""
        k = 0
        while n % 2 == 0 and n > 2 and (n // 2) // s >= self.min_local:
            n //= 2
            k += 1
        return 2 ** (k + 1)

    def layout(self, shape_cells):
        """The finest level's layout, or None where it is replicated."""
        if self.spec(shape_cells) != "sharded":
            return None
        nx, ny, nz = (int(n) for n in shape_cells)
        sy, sz = self.mesh.shape
        cuts = ([0, nx], _even_cuts(ny, sy, self._align(ny, sy)),
                _even_cuts(nz, sz, self._align(nz, sz)))
        devs = self.mesh.devices
        return Layout.from_cuts(shape_cells, cuts,
                                lambda i, j, k: devs[j, k])

    def coarse_layout(self, layout, coarsen, cshape):
        """(layout of the coarse blocks, whether the coarse level is
        sharded): the fine seams halved along the coarsened axes, on the
        fine blocks' devices.  Where the coarse level is replicated the
        layout is used only to restrict and prolong."""
        cuts = [[c // 2 for c in layout.cuts(ax)] if coarsen[ax]
                else layout.cuts(ax) for ax in range(3)]
        devs = iter(layout.devices())
        coarse = Layout.from_cuts(cshape, cuts, lambda *idx: next(devs))
        return coarse, self.spec(cshape) == "sharded"

    def line_layout(self, layout, axis):
        """The layout on which lines along ``axis`` (1 or 2) are relaxed:
        ``axis`` whole, x split over the mesh axis that ``axis`` was split
        over, the third axis as in ``layout``."""
        nx = layout.shape[0]
        sy, sz = self.mesh.shape
        s = sy if axis == 1 else sz
        parts = min(s, nx // 2) if nx >= 4 else 1
        xcuts = _even_cuts(nx, parts, 2)
        whole = [0, layout.shape[axis]]
        devs = self.mesh.devices
        if axis == 1:
            cuts = (xcuts, whole, layout.cuts(2))
            return Layout.from_cuts(layout.shape, cuts,
                                    lambda i, j, k: devs[i, k])
        cuts = (xcuts, layout.cuts(1), whole)
        return Layout.from_cuts(layout.shape, cuts,
                                lambda i, j, k: devs[j, i])

    def level(self, layout, arrays, h, dtypes, host_dtypes=None):
        """A :class:`ShardedLevel` of ``layout`` from the host arrays
        (eta_x, eta_y, eta_z, zeta) and widths ``h``; ``host_dtypes``
        adds the double-precision operator (the finest level)."""
        return ShardedLevel(self, layout, arrays, h, dtypes, host_dtypes)


# ==========================================================================
# A sharded level and its operations.
# ==========================================================================

class _Block:
    """A block's tensors on its device: ``ops`` (eta_x, eta_y, eta_z,
    zeta, hx, hy, hz) of its extent, ``ops64`` in double precision (the
    finest level), and the local transfer metadata."""

    __slots__ = ("ops", "ops64", "rw", "pm", "own_off")

    def __init__(self, ops, ops64=None):
        self.ops, self.ops64 = ops, ops64
        self.rw = self.pm = self.own_off = None


def _block_ops(layout, k, arrays, h, dtypes):
    cdt, rdt = dtypes
    dev = layout.devices()[k]
    sl = layout.ext_slices(k, CELL)
    ops = [torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev, dt)
           for a, dt in zip(arrays, (cdt, cdt, cdt, rdt))]
    ops += [torch.from_numpy(np.ascontiguousarray(h[i][sl[i]])).to(dev, rdt)
            for i in range(3)]
    return tuple(ops)


class ShardedLevel:
    """One multigrid level sharded over blocks of ``layout``.

    The solver's level operations (``solver._relax``, ``_restrict``,
    ``_prolong``, ``_residual_norm_split``, the Krylov operator) call its
    methods where ``lvl.sharded``; fields on it are tuples of
    :class:`Pieces` whose halos equal their owners' entries, before and
    after every method.
    """

    sharded = True

    def __init__(self, placement, layout, arrays, h, dtypes,
                 host_dtypes=None):
        self.placement = placement
        self.layout = layout
        self.h = tuple(np.asarray(x) for x in h)
        self.blocks = []
        for k in range(len(layout.blocks)):
            ops = _block_ops(layout, k, arrays, self.h, dtypes)
            ops64 = None
            if host_dtypes is not None:
                ops64 = (ops if host_dtypes == dtypes else
                         _block_ops(layout, k, arrays, self.h, host_dtypes))
            self.blocks.append(_Block(ops, ops64))
        self.coarse = None          # (layout, sharded, R layout)
        self._lines = {}

    def piece_bytes(self):
        """Bytes of each block's level tensors (``ops``)."""
        return [sum(t.numel() * t.element_size() for t in b.ops)
                for b in self.blocks]

    def set_transfer(self, coarsen, cshape, rw, pm):
        """The transfer to the next coarser level, of ``cshape`` cells,
        from the host weights ``rw`` (per axis (wl, w0, wr) or None) and
        ``pm`` (per axis (idx, w) or None) of the whole grid."""
        lay = self.layout
        clay, csharded = self.placement.coarse_layout(lay, coarsen, cshape)
        # The restricted blocks: the fine extents halved along the
        # coarsened axes, owning the coarse blocks' entries.
        rblocks = []
        for (dev, _, ext), (_, cown, _) in zip(lay.blocks, clay.blocks):
            rext = tuple((a // 2, b // 2) if coarsen[ax] else (a, b)
                         for ax, (a, b) in enumerate(ext))
            rblocks.append((dev, cown, rext))
        self.coarse = (clay, csharded, Layout(clay.shape, rblocks))
        rdt = self.blocks[0].ops[4].dtype
        for k, blk in enumerate(self.blocks):
            dev = lay.devices()[k]
            ext, cext = lay.blocks[k][2], clay.blocks[k][2]
            rwk, pmk, off = [], [], []
            for ax in range(3):
                if not coarsen[ax]:
                    rwk.append(None)
                    pmk.append(None)
                    off.append(0)
                    continue
                (a, b), (ca, cb) = ext[ax], cext[ax]
                rwk.append(tuple(
                    torch.from_numpy(np.ascontiguousarray(
                        w[a // 2:b // 2 + 1])).to(dev, rdt) for w in rw[ax]))
                idx, w = pm[ax]
                idx = np.clip(idx[a:b + 1] - ca, 0, cb - ca - 1)
                pmk.append((torch.from_numpy(idx).to(dev),
                            torch.from_numpy(np.ascontiguousarray(
                                w[a:b + 1])).to(dev, rdt)))
                off.append(a // 2 - ca)
            blk.rw, blk.pm, blk.own_off = tuple(rwk), tuple(pmk), off

    def _line(self, axis):
        """(layout, blocks) on which the lines along ``axis`` run."""
        if axis not in self._lines:
            lay = self.placement.line_layout(self.layout, axis)
            cells = [Pieces([b.ops[i] for b in self.blocks], self.layout,
                            CELL).relayout(lay) for i in range(4)]
            blocks = []
            for k, dev in enumerate(lay.devices()):
                sl = lay.ext_slices(k, CELL)
                rdt = cells[3].dtype
                hs = tuple(torch.from_numpy(np.ascontiguousarray(
                    self.h[i][sl[i]])).to(dev, rdt) for i in range(3))
                blocks.append(_Block((*(c.parts[k] for c in cells), *hs)))
            self._lines[axis] = (lay, blocks)
        return self._lines[axis]

    def relax(self, e, s, nu, axis=None):
        """``nu`` sweeps of the point smoother (``axis`` None) or of the
        line smoother along ``axis``, in place on ``e``: every color on
        every block, then the halos."""
        lay, blocks = self.layout, self.blocks
        work, src = e, s
        if axis in (1, 2) and lay.split(axis):
            lay, blocks = self._line(axis)
            work = tuple(c.relayout(lay) for c in e)
            src = tuple(c.relayout(lay) for c in s)
        runs = [smoothers.phase_runner(
            *(c.parts[k] for c in work), *(c.parts[k] for c in src),
            *blk.ops, axis=axis) for k, blk in enumerate(blocks)]
        shape = lay.shape
        for sweep in range(nu):
            colors = (smoothers.phase_colors(shape, sweep % 2 == 1)
                      if axis is None else smoothers.line_phase_colors(
                          shape, axis, sweep % 2 == 1))
            for c in colors:
                for run in runs:
                    run(*c)
                exchange_halos(work)
        if work is not e:
            for dst, new in zip(e, work):
                dst.assign(new)
        return e

    def _pieces(self, comps, lay=None):
        return tuple(Pieces(p, lay or self.layout, kind)
                     for p, kind in zip(comps, EDGES))

    def amat(self, e):
        """A e block by block with the double-precision operator (halos
        refreshed)."""
        out = [[], [], []]
        for k, blk in enumerate(self.blocks):
            r = operator.amat_x(*(c.parts[k] for c in e), *blk.ops64)
            for i in range(3):
                out[i].append(r[i])
        return exchange_halos(self._pieces(out))

    def residual_norm_split(self, e_hi, e_lo, s):
        """r = s - A (e_hi + e_lo) in double precision, returned in
        working precision, and its norm over owned entries (a 0-d tensor
        on the placement's device)."""
        up = self.blocks[0].ops64[0].dtype
        e = tuple(h.to(up) + lo.to(up) for h, lo in zip(e_hi, e_lo))
        r = tuple(c.to(up) - a for c, a in zip(s, self.amat(e)))
        dev = self.placement.device
        l2 = torch.sqrt(sum(c.sqsum(dev) for c in r))
        return tuple(c.to(e_hi[0].dtype) for c in r), l2

    def restrict(self, e, s, coarsen):
        """Residual + restriction -> (coarse source, zero guess): Pieces
        on the coarse blocks, or whole tensors on the placement's device
        where the coarse level is replicated."""
        clay, csharded, rlay = self.coarse
        out = [[], [], []]
        for k, blk in enumerate(self.blocks):
            res = operator.residual(*(c.parts[k] for c in s),
                                    *(c.parts[k] for c in e), *blk.ops)
            cs = transfer.restrict(*res, blk.rw, coarsen)
            for i in range(3):
                out[i].append(cs[i])
        rs = self._pieces(out, rlay)
        if csharded:
            cs = tuple(c.relayout(clay) for c in rs)
        else:
            cs = gather_field(rs, self.placement.device)
        return cs, tuple(torch.zeros_like(c) for c in cs)

    def prolong(self, e, ce, coarsen):
        """Add the prolonged coarse correction ``ce`` to ``e``, in place."""
        clay = self.coarse[0]
        if not isinstance(ce[0], Pieces):
            ce = tuple(_place(clay, c, kind, c.dtype)
                       for c, kind in zip(ce, EDGES))
        for k, blk in enumerate(self.blocks):
            fine = tuple(c.parts[k] for c in e)
            n = [hi - lo for lo, hi in self.layout.blocks[k][2]]
            coarse = []
            for own, c in enumerate(ce):
                part = c.parts[k]
                if coarsen[own]:
                    part = part.narrow(own - 3, blk.own_off[own],
                                       n[own] // 2)
                coarse.append(part)
            transfer.prolong(*fine, *coarse, blk.pm, coarsen)
        return exchange_halos(e)
