"""Time-domain CSEM modelling via frequency-domain solves.

Copy of ``emg3d_tpu.time`` for the PyTorch port (numpy and scipy
only; the text below speaks of the JAX package it was written for).
API-parity rebuild of the reference Fourier class (emg3d/time.py:33-436,
following Werthmüller/Mulder/Slob 2021): compute the 3-D response at a
coarse, band-limited set of frequencies, interpolate to the full
required range (spline within [fmin, fmax], PCHIP-anchored
extrapolation below fmin, zero above fmax), and transform to time.

The reference outsources the required-frequency computation and the
transform itself to empymod; here both are native
(:mod:`emg3d_tpu.transforms`): self-designed sine/cosine DLF filters
and a splined-DLF evaluation, plus an FFTLog alternative.

Internally the class is organized around a *transform plan* — the
(required-frequency grid, filter) pair implied by ``time``/``ft``/
``ftarg`` — rebuilt whenever one of those inputs changes, while the
band edges ``fmin``/``fmax`` stay cheap attributes whose effect is
evaluated on the fly by the mask helpers.
"""

import warnings
from dataclasses import dataclass

import numpy as np
import scipy as sp

from emg3d_tpu_torch import transforms

__all__ = ['Fourier']


def __dir__():
    return __all__


_FT_CHOICES = ('dlf', 'sin', 'cos', 'fftlog')


@dataclass(frozen=True)
class _TransformPlan:
    """Frequency grid + filter implied by (time, ft, ftarg)."""

    required: np.ndarray        # all frequencies the transform needs
    filt: object                # DLF filter object; None for fftlog

    @classmethod
    def build(cls, time, ft, ftarg):
        if ft not in _FT_CHOICES:
            raise ValueError(
                f"ft must be 'dlf' ('sin'/'cos' aliases) or 'fftlog'; "
                f"got '{ft}'.")

        if ft == 'fftlog':
            freq = transforms.required_frequencies_fftlog(
                time,
                pts_per_dec=ftarg.get('pts_per_dec', 10),
                add_dec=tuple(ftarg.get('add_dec', (-4, 2))))
            return cls(required=freq, filt=None)

        filt = ftarg.get('dlf', None)
        if filt is None or isinstance(filt, str):
            filt = transforms.design_filter()
        freq = transforms.required_frequencies(
            time, filt=filt, pts_per_dec=ftarg.get('pts_per_dec', -1))
        return cls(required=freq, filt=filt)


def _attr(name, doc):
    """Plain stored-attribute property over ``self._<name>``."""

    def fget(self):
        return getattr(self, '_' + name)

    def fset(self, value):
        setattr(self, '_' + name, value)

    return property(fget, fset, doc=doc)


class Fourier:
    """Frequency-to-time management for time-domain CSEM.

    Parameters mirror the reference (time.py:120-146): ``time``, band
    limits ``fmin``/``fmax``, ``signal`` ∈ {-1, 0, 1} (switch-off,
    impulse, switch-on), ``ft`` ('dlf' / 'sin' / 'cos' / 'fftlog'),
    ``ftarg`` (supports ``pts_per_dec`` and a ``DigitalFilter``-like
    object under 'dlf'), and the mutually-exclusive ``input_freq`` /
    ``every_x_freq`` coarsening controls.
    """

    # Band edges and signal: plain stored attributes (their effect is
    # computed on the fly); time re-plans.
    fmin = _attr('fmin', "Minimum frequency (Hz) to compute.")
    fmax = _attr('fmax', "Maximum frequency (Hz) to compute.")
    signal = _attr('signal', "Signal in time domain {-1, 0, 1}.")

    def __init__(self, time, fmin, fmax, signal=0, ft='dlf', ftarg=None,
                 **kwargs):
        self._fmin = fmin
        self._fmax = fmax
        self._signal = signal
        self._ft = ft
        self._ftarg = {} if ftarg is None else dict(ftarg)
        self._input_freq = kwargs.pop('input_freq', None)
        self._every_x_freq = kwargs.pop('every_x_freq', None)
        self.verb = kwargs.pop('verb', 3)
        if kwargs:
            raise TypeError(f"Unexpected **kwargs: {list(kwargs)}.")

        self._resolve_coarsening(prefer='input_freq')
        self._time = np.asarray(time, dtype=np.float64)
        self._replan()

    def __repr__(self):
        return (f"{self.__class__.__name__}: {self._ft}; "
                f"{self.time.min()}-{self.time.max()} s; "
                f"{self.fmin}-{self.fmax} Hz")

    # ---------------- plan management ----------------

    def _replan(self):
        """Recompute the required-frequency grid and filter."""
        self._plan = _TransformPlan.build(self._time, self._ft,
                                          self._ftarg)
        if self.verb > 2:
            freq, calc = self.freq_required, self.freq_compute
            print(f"   Req. freq  [Hz] : {freq.min():.6g} - "
                  f"{freq.max():.6g} ({freq.size})")
            print(f"   Calc. freq [Hz] : {calc.min():.6g} - "
                  f"{calc.max():.6g} ({calc.size})")

    def _resolve_coarsening(self, prefer):
        """Keep only one of the mutually-exclusive coarsening inputs."""
        if self._input_freq is None or self._every_x_freq is None:
            return
        drop = ('every_x_freq' if prefer == 'input_freq'
                else 'input_freq')
        setattr(self, '_' + drop, None)
        warnings.warn(
            "emg3d: `input_freq` and `every_x_freq` are mutually "
            f"exclusive. Re-setting `{drop}=None`.", UserWarning)

    @property
    def _filt(self):
        """The DLF filter in use (None for fftlog)."""
        return self._plan.filt

    # ---------------- frequency bands ----------------

    @property
    def freq_required(self):
        """Frequencies required to carry out the Fourier transform."""
        return self._plan.required

    @property
    def freq_coarse(self):
        """Coarse frequency range (≠ freq_required if decimated)."""
        if self._input_freq is not None:
            return self._input_freq
        if self._every_x_freq is not None:
            return self.freq_required[::self._every_x_freq]
        return self.freq_required

    def _band_mask(self, which):
        """Boolean selector for one of the three frequency bands."""
        if which == 'compute':          # over freq_coarse
            freq = self.freq_coarse
        else:                           # over freq_required
            freq = self.freq_required
        if which == 'extrapolate':
            return freq < self._fmin
        return (freq >= self._fmin) & (freq <= self._fmax)

    # ---------------- re-planning inputs ----------------

    ft = property(lambda self: self._ft,
                  doc="Type of Fourier transform.")
    ftarg = property(lambda self: self._ftarg,
                     doc="Fourier transform arguments.")

    @property
    def time(self):
        """Desired times (s)."""
        return self._time

    @time.setter
    def time(self, time):
        self._time = np.asarray(time, dtype=np.float64)
        self._replan()

    def fourier_arguments(self, ft, ftarg):
        """Set Fourier type and its arguments."""
        self._ft = ft
        self._ftarg = dict(ftarg)
        self._replan()

    # ---------------- the work ----------------

    def interpolate(self, fdata):
        """Expand computed (freq_compute) data to freq_required.

        Reference behavior (time.py:303-355), three bands:

        - within [fmin, fmax]: cubic spline over log-frequency (or a
          pass-through when nothing was decimated);
        - below fmin: monotone PCHIP anchored at a 1e-100 Hz pseudo-DC
          point (real part of the lowest computed frequency, zero
          imaginary part), so the extrapolation tends to the static
          limit instead of oscillating;
        - above fmax: zero.
        """
        fdata = np.asarray(fdata)
        out = np.zeros(self.freq_required.size, dtype=np.complex128)

        decimated = self.freq_coarse.size != self.freq_required.size
        if decimated:
            spline = sp.interpolate.InterpolatedUnivariateSpline
            logf, logx = (np.log(self.freq_compute),
                          np.log(self.freq_interpolate))
            out[self.ifreq_interpolate] = (
                spline(logf, fdata.real)(logx)
                + 1j * spline(logf, fdata.imag)(logx))
        else:
            out[self.ifreq_interpolate] = fdata

        anchor_f = np.r_[1e-100, self.freq_compute]
        anchor_d = np.r_[fdata[0].real - 1e-100j, fdata]
        pchip = sp.interpolate.PchipInterpolator
        xlow = self.freq_extrapolate
        out[self.ifreq_extrapolate] = (
            pchip(anchor_f, anchor_d.real)(xlow)
            + 1j * pchip(anchor_f, anchor_d.imag)(xlow))

        return out

    def freq2time(self, fdata, off):
        """Transform to time domain: the actual Fourier transform.

        Parameters
        ----------
        fdata : ndarray
            Frequency-domain data at ``freq_compute``.
        off : float
            Offset (m); kept for reference API parity (the splined DLF
            does not need it).

        Returns
        -------
        tdata : ndarray
            Time-domain data at ``Fourier.time``.
        """
        full = self.interpolate(fdata)
        if self._ft == 'fftlog':
            tdata = transforms.fourier_fftlog(
                full, self.freq_required, self.time, signal=self.signal)
        else:
            tdata = transforms.fourier_dlf(
                full, self.freq_required, self.time,
                signal=self.signal, filt=self._plan.filt)
        return np.squeeze(tdata)


# Generated accessors: one (ifreq_<band>, freq_<band>) property pair per
# band, and one re-validating property per coarsening control — the
# tables ARE the definition; _band_mask holds the only band logic.

def _install_band(which, source, doc):
    def mask(self):
        return self._band_mask(which)

    def values(self):
        return getattr(self, source)[self._band_mask(which)]

    setattr(Fourier, f'ifreq_{which}',
            property(mask, doc=f"Mask of {source} for '{which}'."))
    setattr(Fourier, f'freq_{which}', property(values, doc=doc))


def _install_coarsening(name, doc):
    def fget(self):
        return getattr(self, '_' + name)

    def fset(self, value):
        setattr(self, '_' + name, value)
        self._resolve_coarsening(prefer=name)

    setattr(Fourier, name, property(fget, fset, doc=doc))


for _band, _source, _doc in (
        ('compute', 'freq_coarse',
         "Frequencies at which the 3-D model has to be solved."),
        ('interpolate', 'freq_required',
         "Frequencies within [fmin, fmax] (spline interpolation)."),
        ('extrapolate', 'freq_required',
         "Frequencies below fmin (PCHIP-anchored extrapolation).")):
    _install_band(_band, _source, _doc)

_install_coarsening('input_freq', "If set, freq_coarse equals input_freq.")
_install_coarsening(
    'every_x_freq',
    "If set, freq_coarse takes every x-th required frequency.")
