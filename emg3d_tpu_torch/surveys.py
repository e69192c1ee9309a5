"""Survey: sources, receivers, frequencies, and data.

Copy of ``emg3d_tpu.surveys`` for the PyTorch port (numpy and scipy
only; the text below speaks of the JAX package it was written for).
Rebuild of the reference's emg3d/surveys.py (reference file cited per
method below).  The reference stores data in an ``xarray.Dataset`` (a soft
dependency, surveys.py:49-53); here a self-contained, dependency-free
``Dataset``/``DataArray`` pair provides the subset of xarray semantics the
framework uses (named (src, rec, freq) axes, ``.loc`` label indexing,
arithmetic, reductions), so the survey layer works everywhere the solver
does — including inside jitted/sharded pipelines, which plain numpy-backed
containers serve better than a host-side xarray graph.
"""

import copy as pycopy

import numpy as np

from emg3d_tpu_torch import electrodes, io, utils

__all__ = ['Survey', 'DataArray', 'Dataset', 'random_noise',
           'txrx_coordinates_to_dict', 'txrx_lists_to_dict',
           'frequencies_to_dict']


def __dir__():
    return __all__


# ==========================================================================
# Minimal named-axis data containers (xarray-free).
# ==========================================================================

class _LocIndexer:
    """Label-based indexer: translates (src, rec, freq) names to indices."""

    def __init__(self, array):
        self._array = array

    def _index(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        key = key + (slice(None),) * (3 - len(key))
        out = []
        for axis, k in enumerate(key):
            names = self._array.coords[axis]
            if isinstance(k, str):
                out.append(names.index(k))
            elif isinstance(k, (list, tuple)) and k and isinstance(
                    k[0], str):
                out.append([names.index(n) for n in k])
            else:
                out.append(k)
        return tuple(out)

    def __getitem__(self, key):
        return self._array.data[self._index(key)]

    def __setitem__(self, key, value):
        self._array.data[self._index(key)] = value


class DataArray:
    """A (nsrc, nrec, nfreq) ndarray with named coordinates.

    Self-contained replacement for the slice of ``xarray.DataArray``
    behavior the framework relies on (reference surveys.py:293-297).
    """

    def __init__(self, data, coords):
        self.data = np.asarray(data)
        self.coords = tuple(tuple(c) for c in coords)
        if self.data.shape != tuple(len(c) for c in self.coords):
            raise ValueError(
                f"Data shape {self.data.shape} does not match coordinates "
                f"{tuple(len(c) for c in self.coords)}.")

    def __repr__(self):
        return (f"DataArray(src={len(self.coords[0])}, "
                f"rec={len(self.coords[1])}, freq={len(self.coords[2])}, "
                f"dtype={self.data.dtype})")

    # -- ndarray protocol ------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        arr = self.data
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        if copy:
            arr = arr.copy()
        return arr

    @property
    def shape(self):
        return self.data.shape

    @property
    def size(self):
        return int(self.data.size)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def values(self):
        return self.data

    @property
    def loc(self):
        return _LocIndexer(self)

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value

    # -- arithmetic (returns DataArray, coords preserved) ------------------
    def _binop(self, other, op):
        other_data = other.data if isinstance(other, DataArray) else other
        return DataArray(op(self.data, other_data), self.coords)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._binop(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a)

    def __pow__(self, p):
        return DataArray(self.data ** p, self.coords)

    def __neg__(self):
        return DataArray(-self.data, self.coords)

    def __abs__(self):
        return DataArray(np.abs(self.data), self.coords)

    def conj(self):
        return DataArray(np.conj(self.data), self.coords)

    def copy(self, data=None):
        """Copy; optionally with replaced data (xarray-compatible)."""
        if data is None:
            data = self.data.copy()
        return DataArray(np.asarray(data), self.coords)

    def count(self):
        """Number of finite (non-NaN) entries."""
        return int(np.isfinite(self.data).sum())

    def sel(self, src=None, rec=None, freq=None):
        """Select by coordinate names (lists of str); returns DataArray."""
        idx = []
        new_coords = []
        for axis, sel in enumerate((src, rec, freq)):
            names = self.coords[axis]
            if sel is None:
                idx.append(np.arange(len(names)))
                new_coords.append(names)
            else:
                if isinstance(sel, str):
                    sel = [sel]
                idx.append(np.array([names.index(n) for n in sel]))
                new_coords.append(tuple(sel))
        data = self.data[np.ix_(*idx)]
        return DataArray(data, new_coords)


class Dataset:
    """Named collection of DataArrays sharing (src, rec, freq) coords."""

    def __init__(self, data_vars, coords, attrs=None):
        self._vars = {}
        self.coords = tuple(tuple(c) for c in coords)
        self.attrs = dict(attrs or {})
        for k, v in data_vars.items():
            self[k] = v

    # -- dict protocol -----------------------------------------------------
    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    def values(self):
        return self._vars.values()

    def __contains__(self, key):
        return key in self._vars

    def __iter__(self):
        return iter(self._vars)

    def __getitem__(self, key):
        return self._vars[key]

    def __setitem__(self, key, value):
        if not isinstance(value, DataArray):
            value = DataArray(np.asarray(value), self.coords)
        if value.coords != self.coords:
            raise ValueError(f"Coordinate mismatch for '{key}'.")
        self._vars[key] = value

    def __delitem__(self, key):
        del self._vars[key]

    def __getattr__(self, name):
        # Attribute access for data variables and attrs (xarray-style).
        vars_ = object.__getattribute__(self, '_vars')
        if name in vars_:
            return vars_[name]
        attrs = object.__getattribute__(self, 'attrs')
        if name in attrs:
            return attrs[name]
        raise AttributeError(name)

    def __repr__(self):
        ns, nr, nf = (len(c) for c in self.coords)
        lines = [f":: Dataset :: {ns} sources; {nr} receivers; "
                 f"{nf} frequencies"]
        lines += [f"  - {k}: {v.dtype}" for k, v in self._vars.items()]
        for k, v in self.attrs.items():
            lines.append(f"  * {k}: {v}")
        return "\n".join(lines)


# ==========================================================================
# Survey.
# ==========================================================================

@utils._known_class
class Survey:
    """Sources, receivers, frequencies, and (nsrc, nrec, nfreq) data.

    API-parity rebuild of the reference Survey (emg3d/surveys.py:41-732),
    without the xarray dependency.  Receivers support the ``relative``
    switch for streamer-type acquisitions (surveys.py:55-60).
    """

    # Optional metadata accepted as keyword arguments.
    _META = ('noise_floor', 'relative_error', 'name', 'date', 'info')

    def __init__(self, sources, receivers, frequencies, data=None,
                 **kwargs):
        self._sources = txrx_lists_to_dict(sources)
        self._receivers = ({} if receivers is None
                           else txrx_lists_to_dict(receivers))
        self._frequencies = frequencies_to_dict(frequencies)

        self._initiate_dataset(data)

        for key in self._META:
            setattr(self, key, kwargs.pop(key, None))
        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs.keys())}.")

    def __repr__(self):
        head = f":: {type(self).__name__}"
        if self.name:
            head += f" «{self.name}»"
        head += " ::"
        if self.date:
            head += f" {self.date}"
        if self.info:
            head += f"\n{self.info}"
        return f"{head}\n\n{self.data!r}"

    def copy(self):
        """Return a copy of the Survey."""
        return self.from_dict(self.to_dict(True))

    def to_dict(self, copy=False):
        """Store the necessary information of the Survey in a dict."""
        out = {'__class__': type(self).__name__}
        for group in ('sources', 'receivers'):
            out[group] = {k: v.to_dict()
                          for k, v in getattr(self, group).items()}
        out['frequencies'] = self.frequencies
        out['data'] = {k: v.data for k, v in self.data.items()}
        out.update((key, getattr(self, key)) for key in self._META)
        return pycopy.deepcopy(out) if copy else out

    @classmethod
    def from_dict(cls, inp):
        """Create a Survey from a dict (from :meth:`Survey.to_dict`)."""
        def _electrode(v):
            # io may have deserialized nested electrodes already.
            if isinstance(v, dict):
                return getattr(electrodes, v['__class__']).from_dict(v)
            return v

        inp = {k: v for k, v in inp.items() if k != '__class__'}
        inp['sources'] = {
            k: _electrode(v) for k, v in inp['sources'].items()}
        inp['receivers'] = {
            k: _electrode(v) for k, v in inp['receivers'].items()}
        # Normalize noise floor / rel. error: arrays were stored expanded.
        for key in ('noise_floor', 'relative_error'):
            val = inp.get(key)
            if isinstance(val, str):
                inp[key] = np.asarray(inp['data']['_' + key])
        return cls(**inp)

    def to_file(self, fname, name='survey', **kwargs):
        """Store Survey to a file (h5/npz/json via :func:`io.save`)."""
        kwargs[name] = self
        return io.save(fname, **kwargs)

    @classmethod
    def from_file(cls, fname, name='survey', **kwargs):
        """Load Survey from a file."""
        out = io.load(fname, **kwargs)
        if kwargs.get('verb', 0) < 0:
            return out[0][name], out[1]
        return out[name]

    # -- data --------------------------------------------------------------
    def _initiate_dataset(self, data):
        """Initiate the Dataset; always contains 'observed'."""
        shape = (len(self._sources), len(self._receivers),
                 len(self._frequencies))

        if data is None:
            data = {'observed': np.full(shape, np.nan + 1j * np.nan)}
        elif not isinstance(data, dict):
            data = {'observed': np.atleast_3d(data)}
        elif 'observed' not in data.keys():
            data = {**data,
                    'observed': np.full(shape, np.nan + 1j * np.nan)}

        coords = (list(self._sources), list(self._receivers),
                  list(self._frequencies))
        self._data = Dataset(
            {k: np.asarray(v) for k, v in data.items()}, coords)

    @property
    def data(self):
        """The data, a :class:`Dataset` instance."""
        return self._data

    def select(self, sources=None, receivers=None, frequencies=None,
               remove_empty=True):
        """Return a Survey with selected sources/receivers/frequencies.

        Mirrors reference surveys.py:316-401, including the removal of
        empty source-receiver-frequency entries.
        """
        survey = self.to_dict()
        wanted = {'sources': sources, 'receivers': receivers,
                  'frequencies': frequencies}
        selection = {}
        for (group, names), dim in zip(wanted.items(),
                                       ('src', 'rec', 'freq')):
            if names is None:
                continue
            names = [names] if isinstance(names, str) else names
            survey[group] = {n: survey[group][n] for n in names}
            selection[dim] = names

        for key in survey['data'].keys():
            survey['data'][key] = self.data[key].sel(**selection).data
            if remove_empty and key == 'observed':
                data = survey['data'][key]
                remove_empty = bool(np.isfinite(data).any())

        reduced = Survey.from_dict(survey)
        if not remove_empty:
            return reduced

        # Second pass: drop rows/columns/slices that are all-NaN in the
        # selected observed data.
        def kept(group, axis):
            others = tuple(i for i in range(3) if i != axis)
            keep = ~np.isnan(data).all(axis=others)
            return [n for n, k in zip(survey[group], keep) if k]

        return reduced.select(
            sources=kept('sources', 0), receivers=kept('receivers', 1),
            frequencies=kept('frequencies', 2), remove_empty=False)

    @property
    def shape(self):
        """Shape of data (nsrc, nrec, nfreq)."""
        return self.data.observed.shape

    @property
    def size(self):
        """Size of data (nsrc x nrec x nfreq)."""
        return int(self.data.observed.size)

    @property
    def count(self):
        """Count of observed (finite) data."""
        return self.data.observed.count()

    # -- sources, receivers, frequencies ------------------------------------
    @property
    def sources(self):
        """Source dict containing all sources."""
        return self._sources

    @property
    def receivers(self):
        """Receiver dict containing all receivers."""
        return self._receivers

    @property
    def frequencies(self):
        """Frequency dict containing all frequencies."""
        return self._frequencies

    def source_coordinates(self):
        """Source center coordinates as ndarray [x, y, z]."""
        return np.array([s.center for s in self.sources.values()]).T

    def receiver_coordinates(self, source=None):
        """Receiver center coordinates as ndarray [x, y, z].

        Relative receivers are expanded per source (surveys.py:432-458).
        """
        coords = []
        for v in self.receivers.values():
            if v.relative and source is None:
                for s in self.sources.values():
                    coords.append(v.center_abs(s))
            elif v.relative:
                coords.append(v.center_abs(self.sources[source]))
            else:
                coords.append(v.center)
        return np.array(coords).T

    # -- standard deviation and noise ----------------------------------------
    @property
    def standard_deviation(self):
        r"""Standard deviation: sqrt(nf² + (re·|d|)²) (surveys.py:466-533).

        A directly-set standard deviation is prioritized over noise floor
        and relative error.
        """
        if 'standard_deviation' in self._data.keys():
            return self.data['standard_deviation']

        if self.noise_floor is not None or self.relative_error is not None:
            std = self.data.observed.copy(data=np.zeros(self.shape))
            if self.noise_floor is not None:
                std += np.asarray(self.noise_floor) ** 2
            if self.relative_error is not None:
                std += np.abs(
                    np.asarray(self.relative_error)
                    * self.data.observed.data) ** 2
            return DataArray(np.sqrt(std.data), std.coords)

        return None

    @standard_deviation.setter
    def standard_deviation(self, standard_deviation):
        if standard_deviation is not None:
            if np.any(np.asarray(standard_deviation) <= 0.0):
                raise ValueError(
                    "All values of `standard_deviation` must be bigger "
                    f"than zero. Provided: {standard_deviation}.")
            self._data['standard_deviation'] = self.data.observed.copy(
                data=np.broadcast_to(
                    standard_deviation, self.shape).copy())
        elif 'standard_deviation' in self.data:
            del self._data['standard_deviation']

    @property
    def noise_floor(self):
        """Noise floor of the data (see standard_deviation)."""
        val = self.data.attrs.get('noise_floor')
        if isinstance(val, str):
            return self.data['_noise_floor'].data
        return val

    @noise_floor.setter
    def noise_floor(self, noise_floor):
        self._set_nf_re('noise_floor', noise_floor)

    @property
    def relative_error(self):
        """Relative error of the data (see standard_deviation)."""
        val = self.data.attrs.get('relative_error')
        if isinstance(val, str):
            return self.data['_relative_error'].data
        return val

    @relative_error.setter
    def relative_error(self, relative_error):
        self._set_nf_re('relative_error', relative_error)

    def _set_nf_re(self, name, value):
        """Store noise_floor or relative_error (scalar or full array)."""
        if value is not None and not isinstance(value, str):
            value = np.asarray(value)
            if np.any(value <= 0.0):
                raise ValueError(
                    f"All values of `{name}` must be bigger than zero. "
                    f"Provided: {value}.")
            if value.size == 1:
                value = float(value)
            else:
                self.data['_' + name] = self.data.observed.copy(
                    data=np.ones(self.shape) * value)
                value = 'data._' + name
        self._data.attrs[name] = value

    def add_noise(self, min_offset=0.0, min_amplitude='half_nf',
                  add_to='observed', **kwargs):
        """Add random noise; prune close/low-signal data (surveys.py:590+).

        ``max_offset`` can be given in kwargs; remaining kwargs go to
        :func:`random_noise`.
        """
        if add_to not in self.data.keys():
            self.data[add_to] = self.data.observed.copy(
                data=np.zeros(self.shape, dtype=complex))

        if min_amplitude == 'half_nf':
            min_amplitude = self.noise_floor
            if min_amplitude is not None:
                min_amplitude = np.asarray(min_amplitude) / 2.0
        if min_amplitude is not None:
            cut_amp = np.abs(self.data.observed.data) < min_amplitude
            self.data[add_to].data[cut_amp] = np.nan + 1j * np.nan

        max_offset = kwargs.pop('max_offset', np.inf)
        if min_offset > 0.0 or max_offset < np.inf:
            for ks, s in self.sources.items():
                for kr, r in self.receivers.items():
                    off = np.linalg.norm(r.center_abs(s) - s.center)
                    if off < min_offset or off > max_offset:
                        self.data[add_to].loc[ks, kr, :] = (
                            np.nan + 1j * np.nan)

        if self.standard_deviation is not None:
            noise = random_noise(self.standard_deviation.data, **kwargs)
            self.data[add_to].data += noise

    # -- internals used by Simulation ----------------------------------------
    @property
    def _irec_types(self):
        """Indices of electric and magnetic receivers."""
        if getattr(self, '_ierec', None) is None:
            rec_types = tuple(r.xtype == 'electric'
                              for r in self.receivers.values())
            self._ierec = np.nonzero(rec_types)[0]
            self._imrec = np.nonzero(np.logical_not(rec_types))[0]
        return self._ierec, self._imrec

    def _rec_types_coord(self, source):
        """Absolute receiver coordinates per type for a given source."""
        if getattr(self, '_rec_coord', None) is None:
            self._rec_coord = {}
        if source not in self._rec_coord.keys():
            self._rec_coord[source] = np.array(
                [r.coordinates_abs(self.sources[source])
                 for r in self.receivers.values()])
        indices = self._irec_types
        return [tuple(self._rec_coord[source][ind].T) for ind in indices]

    @property
    def isfinite(self):
        """Boolean mask of the finite observed data."""
        if not hasattr(self, '_isfinite'):
            finite = np.isfinite(self.data.observed.data)
            if finite.sum() > 0:
                self._isfinite = finite
        else:
            finite = self._isfinite
        return finite

    def finite_data(self, data='observed'):
        """Finite elements of the selected data set."""
        return self.data[data].data[self.isfinite]


# ==========================================================================
# Noise and dict helpers.
# ==========================================================================

def random_noise(standard_deviation, mean_noise=0.0, ntype='white_noise',
                 rng=None):
    """Random noise realizations (reference surveys.py:734-847).

    ntype: 'white_noise' (uniform random phases, constant amplitude),
    'gaussian_correlated', or 'gaussian_uncorrelated'.  ``rng`` (a numpy
    ``Generator`` or a seed; only in the port) makes the realization
    repeatable; with None every call draws fresh entropy, as in
    ``emg3d_tpu``.  ``Survey.add_noise`` and ``Simulation.compute(
    observed=True)`` pass it through.
    """
    shape = np.asarray(standard_deviation).shape
    rng = np.random.default_rng(rng)

    if ntype == 'gaussian_uncorrelated':
        noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    elif ntype == 'gaussian_correlated':
        noise = rng.standard_normal(shape) * (1 + 1j)
    else:
        noise = np.exp(1j * rng.uniform(0, 2 * np.pi, shape))

    return standard_deviation * ((1 + 1j) * mean_noise + noise)


def txrx_coordinates_to_dict(TxRx, coordinates, **kwargs):
    """Create a dict of TxRx instances from coordinate arrays.

    Each coordinate element has length 1 or n (surveys.py:848-913).
    """
    nd = max(np.array(n, ndmin=1).size for n in coordinates)

    coo = np.array([nd * [val] if np.array(val).size == 1 else val
                    for val in coordinates], dtype=np.float64)

    inp = {}
    for i in range(nd):
        inp[i] = {k: (v if np.array(v).size == 1 else v[i])
                  for k, v in kwargs.items()}

    return txrx_lists_to_dict(
        [TxRx(coo[:, i], **inp[i]) for i in range(nd)])


def txrx_lists_to_dict(txrx):
    """Flatten lists/dicts of Tx/Rx instances into a keyed dict.

    Keys are '<prefix>-<i>' (e.g. 'TxED-1'); dicts pass through
    unaltered (surveys.py:914-1001).
    """
    if isinstance(txrx, dict):
        return txrx

    if hasattr(txrx, '_prefix'):
        txrx = [txrx]

    elif any(isinstance(el, (list, tuple, dict)) for el in txrx):
        new_txrx = []
        for trx in txrx:
            if hasattr(trx, '_prefix'):
                trx = [trx]
            elif isinstance(trx, dict):
                trx = list(trx.values())
            new_txrx += trx
        txrx = new_txrx

    nx = len(txrx)
    return {f"{trx._prefix}-{i+1:0{len(str(nx))}d}": trx
            for i, trx in enumerate(txrx)}


def frequencies_to_dict(frequencies):
    """Key frequencies as 'f-1', 'f-2', ... (surveys.py:1004-1038)."""
    if not isinstance(frequencies, dict):
        freqs = np.array(frequencies, dtype=np.float64, ndmin=1)
        if freqs.size != np.unique(freqs).size:
            raise ValueError(f"Contains non-unique frequencies: {freqs}.")
        frequencies = {f"f-{i+1:0{len(str(freqs.size))}d}": freq
                       for i, freq in enumerate(freqs)}
    return frequencies
