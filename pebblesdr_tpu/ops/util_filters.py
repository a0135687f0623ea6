"""Misc DSP utilities (SURVEY.md §2.1 "Misc DSP utilities" row).

Capability parity with:
  * MovingAvgFilter (pebblelib/movingavgfilter.h:24-61): uniform / weighted /
    exponential moving averages with running variance & stdDev;
  * MedianFilter<T> (pebblelib/medianfilter.h): sliding median;
  * DelayLine (pebblelib/delayline.h:13-28): ring-buffer delay + MAC;
  * Butterworth (pebblelib/butterworth.h:35): classic IIR design (as SOS
    biquad cascade via ops.iir);
  * SampleClock (pebblelib/sampleclock.h:8): sample-count timing;
  * ALawCompression (pebblelib/alawcompression.h:11): G.711 a-law (ghpsdr3
    audio wire format).

All array ops are vectorized jnp over [C, N]; design helpers are host-side.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal

from pebblesdr_tpu.core.precision import DOT_PRECISION
from pebblesdr_tpu.ops import iir as iir_mod


# ------------------------------------------------------------ moving average

def moving_avg(x: jax.Array, window: int, tail: jax.Array | None = None,
               weights: jax.Array | None = None):
    """Sliding average (uniform, or weighted when `weights` given) over the
    trailing `window` samples.  x: [C, N]; tail: [C, window-1] carried
    history.  Returns (y [C, N], new_tail)."""
    c, n = x.shape
    if tail is None:
        tail = jnp.zeros((c, window - 1), x.dtype)
    ext = jnp.concatenate([tail, x], axis=-1)
    if weights is None:
        cs = jnp.cumsum(jnp.concatenate(
            [jnp.zeros((c, 1), x.dtype), ext], axis=-1), axis=-1)
        y = (cs[:, window:] - cs[:, :-window]) / window
    else:
        w = (weights / jnp.sum(weights))[::-1].astype(jnp.float32)
        lhs = ext[:, None, :]
        rhs = w[None, None, :]
        y = jax.lax.conv_general_dilated(
            lhs, rhs, (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"),
            precision=DOT_PRECISION)[:, 0]
    return y, ext[:, -(window - 1):]


def moving_variance(x: jax.Array, window: int):
    """Sliding mean/variance/std over the trailing window (MovingAvgFilter
    variance capability).  Returns (mean, var, std) each [C, N-window+1]."""
    m, _ = moving_avg(x, window, tail=jnp.zeros((x.shape[0], window - 1), x.dtype))
    m2, _ = moving_avg(x * x, window, tail=jnp.zeros((x.shape[0], window - 1), x.dtype))
    var = jnp.maximum(m2 - m * m, 0.0)
    return m, var, jnp.sqrt(var)


# ------------------------------------------------------------------- median

def median_filter(x: jax.Array, window: int):
    """Sliding median over a centered window (edges: shrunk window via
    sort-of-padded values).  x: [C, N] -> [C, N]."""
    c, n = x.shape
    pad = window // 2
    ext = jnp.pad(x, ((0, 0), (pad, pad)), mode="edge")
    idx = jnp.arange(n)[:, None] + jnp.arange(window)[None, :]
    frames = ext[:, idx]                      # [C, N, W]
    return jnp.median(frames, axis=-1)


# ---------------------------------------------------------------- delay line

@dataclasses.dataclass(frozen=True)
class DelayLinePlan:
    delay: int


def delay_line(x: jax.Array, delay: int, tail: jax.Array | None = None):
    """Pure delay by `delay` samples with carried state (DelayLine capability;
    the MAC use-case is fir_apply).  Returns (y, new_tail [C, delay])."""
    c, n = x.shape
    if tail is None:
        tail = jnp.zeros((c, delay), x.dtype)
    full = jnp.concatenate([tail, x], axis=-1)
    return full[:, :n], full[:, n:]


# --------------------------------------------------------------- butterworth

def design_butterworth(order: int, cutoff_hz, sample_rate: float,
                       kind: str = "lowpass") -> list[iir_mod.BiquadCoef]:
    """Butterworth LP/HP/BP as a cascade of biquad sections (apply each with
    ops.iir.biquad_apply)."""
    btype = {"lowpass": "lowpass", "highpass": "highpass",
             "bandpass": "bandpass"}[kind]
    sos = scipy.signal.butter(order, cutoff_hz, btype=btype, fs=sample_rate,
                              output="sos")
    out = []
    for b0, b1, b2, a0, a1, a2 in sos:
        out.append(iir_mod.BiquadCoef(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0))
    return out


def butterworth_apply(states: list[jax.Array], x: jax.Array,
                      coefs: list[iir_mod.BiquadCoef]):
    new_states = []
    y = x
    for st, cf in zip(states, coefs):
        st2, y = iir_mod.biquad_apply(st, y, cf)
        new_states.append(st2)
    return new_states, y


# -------------------------------------------------------------- sample clock

@dataclasses.dataclass
class SampleClock:
    """Sample-count wall clock (SampleClock capability): convert running
    sample counts to seconds/durations at a fixed rate."""
    sample_rate: float
    count: int = 0

    def tick(self, n: int = 1) -> None:
        self.count += n

    @property
    def seconds(self) -> float:
        return self.count / self.sample_rate

    def duration(self, start_count: int) -> float:
        return (self.count - start_count) / self.sample_rate


# -------------------------------------------------------------------- a-law

def alaw_compress(x: np.ndarray) -> np.ndarray:
    """float32 [-1,1] -> u8 G.711 a-law (ghpsdr3 audio wire format)."""
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    sign = (pcm >> 8) & 0x80
    mag = np.where(sign != 0, -pcm.astype(np.int32), pcm.astype(np.int32))
    mag = np.minimum(mag, 32635)
    exp = np.zeros_like(mag)
    for e in range(7, 0, -1):
        exp = np.where((mag >> (e + 7)) & 1 == 1, np.maximum(exp, e), exp)
    mant = np.where(exp == 0, (mag >> 4) & 0x0F, (mag >> (exp + 3)) & 0x0F)
    val = (sign | (exp << 4) | mant).astype(np.uint8)
    return val ^ 0x55


def alaw_expand(a: np.ndarray) -> np.ndarray:
    """u8 a-law -> float32 [-1,1]."""
    a = a.astype(np.uint8) ^ 0x55
    sign = a & 0x80
    exp = (a >> 4) & 0x07
    mant = (a & 0x0F).astype(np.int32)
    mag = np.where(exp == 0, (mant << 4) + 8, ((mant << 4) + 0x108) << (exp - 1))
    pcm = np.where(sign != 0, -mag, mag).astype(np.float32)
    return pcm / 32768.0
