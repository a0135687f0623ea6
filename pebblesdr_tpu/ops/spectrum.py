"""Windowed-FFT power spectrum: dB spectra, averaging, overload, screen mapping.

Capability parity with FFT/SignalSpectrum (pebblelib/fft.{h,cpp},
application/signalspectrum.cpp):
  * window apply + input overload detect (fft.cpp:129-157),
  * unfold to -f..+f bin order (fft.cpp:183-225)  -> jnp.fft.fftshift,
  * power spectrum in dB normalized by N and window coherent gain
    (calcPowerAverages, fft.cpp:324+), with a display dB offset,
  * exponential power averaging across frames,
  * mapFFTToScreen pixel binning (signalspectrum.cpp:137-168): max-bin
    reduction of FFT bins onto a pixel grid.

The reference's four FFT backends (FFTW/Ooura/CuteSDR/Accelerate, fft.cpp:45-65)
collapse to XLA's native batched FFT.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core import db as dbu
from pebblesdr_tpu.core import windows as win
from pebblesdr_tpu.core.block import pytree_dataclass
from pebblesdr_tpu.core.precision import DOT_PRECISION

MIN_BINS = 2048   # fft.h:21
MAX_BINS = 65535  # fft.h:22
OVERLOAD_LEVEL = 1.0  # |sample| above full scale = ADC overload (fft.cpp:138-142 analog)


def make_window(n_bins: int, kind: win.WindowType = win.WindowType.BLACKMAN_HARRIS):
    """Returns (window [n] float32 device-ready, coherent_gain scalar)."""
    w = win.window(kind, n_bins, periodic=True)
    return np.asarray(w, np.float32), win.coherent_gain(w)


# DFT-by-matmul for the display/S-meter sizes (<= 4096 bins): the transform
# as real matmuls against cached matrices (fp32, fftshifted row order so no
# separate shift pass).  Larger sizes take jnp.fft.
_DFT_MAX_MATMUL = 4096
_dft_cache: dict[int, tuple[jax.Array, jax.Array]] = {}


def _dft_mats(n: int) -> tuple[jax.Array, jax.Array]:
    """Cached DEVICE arrays: closure-captured concrete arrays are lifted as
    implicit jit parameters instead of being baked into the HLO as
    multi-MB literals."""
    if n not in _dft_cache:
        k = np.arange(n)
        shifted_rows = np.fft.fftshift(k)  # output bin order -f..+f
        w = np.exp(-2j * np.pi * np.outer(k, shifted_rows) / n)
        # concrete even when first touched inside a jit trace (a traced
        # jnp.asarray would leak a tracer into the cache)
        with jax.ensure_compile_time_eval():
            _dft_cache[n] = (jnp.asarray(w.real.astype(np.float32)),
                             jnp.asarray(w.imag.astype(np.float32)))
    return _dft_cache[n]


def _shifted_power(xw: jax.Array) -> jax.Array:
    """|fftshift(fft(xw))|^2 for [C, N] complex64, via DFT matmuls."""
    n = xw.shape[-1]
    if n > _DFT_MAX_MATMUL:
        spec = jnp.fft.fftshift(jnp.fft.fft(xw, axis=-1), axes=-1)
        return spec.real**2 + spec.imag**2
    fr, fi = _dft_mats(n)
    xr, xi = xw.real, xw.imag
    # true-f32 products (core.precision): a reduced-precision product
    # lifts the display/S-meter noise floor by tens of dB, and the
    # Karatsuba form below cancels terms
    # Karatsuba complex product: 3 real products instead of 4 (the zoomed
    # transform runs EVERY block for the S-meter/squelch).
    # si = t3 - t1 - t2 with t3 = (xr+xi)(fr+fi)
    t1 = jnp.matmul(xr, fr, precision=DOT_PRECISION)
    t2 = jnp.matmul(xi, fi, precision=DOT_PRECISION)
    t3 = jnp.matmul(xr + xi, fr + fi, precision=DOT_PRECISION)
    sr = t1 - t2
    si = t3 - t1 - t2
    return sr * sr + si * si


@pytree_dataclass
class SpectrumState:
    avg_power: jax.Array  # [C, bins] linear power running average


def state_init(channels: int, n_bins: int) -> SpectrumState:
    return SpectrumState(avg_power=jnp.zeros((channels, n_bins), jnp.float32))


def power_spectrum(x: jax.Array, window: jax.Array, coherent_gain: float,
                   db_offset: float = 0.0):
    """x: [C, N] complex64 -> (spectrum_db [C, N] fftshifted, overload [C] bool).

    0 dB == full-scale coherent tone (window coherent gain normalized out,
    matching fft.cpp:351-360 semantics).
    """
    n = x.shape[-1]
    overload = jnp.max(jnp.abs(x.real), axis=-1) > OVERLOAD_LEVEL
    xw = x * window[None, :]
    norm = 1.0 / (n * coherent_gain)
    power = _shifted_power(xw) * (norm * norm)
    return dbu.power_to_db(power) + db_offset, overload


def averaged_spectrum(state: SpectrumState, x: jax.Array, window: jax.Array,
                      coherent_gain: float, smoothing: float = 0.0,
                      db_offset: float = 0.0):
    """Like power_spectrum but with exponential averaging in the linear-power
    domain.  smoothing=0 -> no averaging.  Returns (state', db [C,N], overload)."""
    n = x.shape[-1]
    overload = jnp.max(jnp.abs(x.real), axis=-1) > OVERLOAD_LEVEL
    xw = x * window[None, :]
    norm = 1.0 / (n * coherent_gain)
    power = _shifted_power(xw) * (norm * norm)
    a = jnp.asarray(smoothing, jnp.float32)
    avg = a * state.avg_power + (1.0 - a) * power
    return SpectrumState(avg_power=avg), dbu.power_to_db(avg) + db_offset, overload


class Waterfall:
    """Host-side rolling waterfall buffer (SpectrumWidget waterfall-mode data
    product, spectrumwidget.h:18-90): push per-block dB rows, read a [rows,
    pixels] image array (newest last)."""

    def __init__(self, n_pixels: int, depth: int = 256):
        self.n_pixels = n_pixels
        self.depth = depth
        self._buf = np.full((depth, n_pixels), -160.0, np.float32)

    def push(self, spectrum_db) -> None:
        row = np.asarray(map_to_screen(
            jnp.asarray(spectrum_db)[None] if np.ndim(spectrum_db) == 1
            else jnp.asarray(spectrum_db), self.n_pixels))[0]
        self._buf = np.roll(self._buf, -1, axis=0)
        self._buf[-1] = row

    @property
    def image(self) -> np.ndarray:
        return self._buf


def map_to_screen(spectrum_db: jax.Array, n_pixels: int):
    """Max-bin FFT->pixel reduction (mapFFTToScreen capability,
    signalspectrum.cpp:137-168).  Requires bins % n_pixels == 0 (the chain
    planner picks bin counts accordingly); max preserves narrow signals."""
    c, bins = spectrum_db.shape
    assert bins % n_pixels == 0, "bins must divide evenly into pixels"
    return jnp.max(spectrum_db.reshape(c, n_pixels, bins // n_pixels), axis=-1)
