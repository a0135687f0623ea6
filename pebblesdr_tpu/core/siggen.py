"""Test-signal generators: tone / Gaussian noise / sweep with pulse modulation.

Capability parity with the reference NCO generators used by TestBench and tests
(pebblelib/nco.cpp:87-212: genSingle, genNoise [Box-Muller], genSweep with
SINGLE/REPEAT/REPEAT_REVERSE sweep and pulse on/off modulation).  These are the
foundation of the test strategy (SURVEY.md §4): inject a calibrated signal at a
known dB and assert chain behavior.

All generators are pure: ``(state, n) -> (state', samples[n] complex64)`` so a
continuous signal can be produced block-by-block with phase continuity.
Amplitudes are linear; use core.db.db_to_amplitude for calibrated dB levels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pebblesdr_tpu.core.block import pytree_dataclass

TWO_PI = 2.0 * jnp.pi


@pytree_dataclass
class ToneState:
    phase: jax.Array  # fractional cycles in [0,1)


def tone_init() -> ToneState:
    return ToneState(phase=jnp.zeros((), jnp.float32))


def tone(state: ToneState, n: int, freq_hz, sample_rate: float, amplitude=1.0):
    """Complex exponential at freq_hz; phase carried across blocks."""
    f = jnp.asarray(freq_hz, jnp.float32) / sample_rate
    k = jnp.arange(n, dtype=jnp.float32)
    ph = jnp.mod(state.phase + jnp.mod(f * k, 1.0), 1.0)
    y = amplitude * jnp.exp(1j * TWO_PI * ph).astype(jnp.complex64)
    new_phase = jnp.mod(state.phase + jnp.mod(f * n, 1.0), 1.0)
    return ToneState(phase=new_phase), y


def noise(key: jax.Array, n: int, db_level: float = 0.0):
    """Complex Gaussian noise at the given total power in dB (0 dB = unit power).

    The reference uses Box-Muller per sample (nco.cpp:87-116); here we draw
    from jax.random.normal — identical distribution, vectorized.
    """
    amp = 10.0 ** (db_level / 20.0) / jnp.sqrt(2.0)
    kr, ki = jax.random.split(key)
    re = jax.random.normal(kr, (n,), jnp.float32)
    im = jax.random.normal(ki, (n,), jnp.float32)
    return (amp * jax.lax.complex(re, im)).astype(jnp.complex64)


@pytree_dataclass
class SweepState:
    phase: jax.Array       # carrier fractional cycles [0,1)
    freq: jax.Array        # current sweep frequency (Hz)
    direction: jax.Array   # +1 / -1 (for REPEAT_REVERSE)
    pulse_count: jax.Array # samples into the pulse period


def sweep_init(start_hz: float) -> SweepState:
    return SweepState(
        phase=jnp.zeros((), jnp.float32),
        freq=jnp.asarray(start_hz, jnp.float32),
        direction=jnp.ones((), jnp.float32),
        pulse_count=jnp.zeros((), jnp.int32),
    )


def sweep(
    state: SweepState,
    n: int,
    start_hz: float,
    stop_hz: float,
    rate_hz_per_sec: float,
    sample_rate: float,
    amplitude=1.0,
    mode: str = "repeat",          # "single" | "repeat" | "repeat_reverse"
    pulse_on_samples: int = 0,     # 0 => continuous
    pulse_period_samples: int = 0,
):
    """Frequency sweep generator with optional pulse (on/off) modulation.

    Scan-based: frequency advances rate/fs per sample, wrapping per mode, and
    the carrier phase integrates the instantaneous frequency (as the reference
    does per-sample in nco.cpp:119-212).
    """
    df = rate_hz_per_sec / sample_rate

    def step(carry, _):
        ph, f, d, pc = carry
        ph = jnp.mod(ph + f / sample_rate, 1.0)
        f2 = f + d * df
        if mode == "single":
            f2 = jnp.clip(f2, min(start_hz, stop_hz), max(start_hz, stop_hz))
            d2 = d
        elif mode == "repeat":
            wrap = f2 > stop_hz
            f2 = jnp.where(wrap, start_hz, f2)
            d2 = d
        else:  # repeat_reverse
            hit_hi = f2 > stop_hz
            hit_lo = f2 < start_hz
            d2 = jnp.where(hit_hi | hit_lo, -d, d)
            f2 = jnp.clip(f2, start_hz, stop_hz)
        if pulse_period_samples > 0:
            on = pc < pulse_on_samples
            pc2 = jnp.mod(pc + 1, pulse_period_samples)
        else:
            on = jnp.asarray(True)
            pc2 = pc
        samp = jnp.where(on, jnp.exp(1j * TWO_PI * ph), 0.0 + 0.0j)
        return (ph, f2, d2, pc2), samp

    init = (state.phase, state.freq, state.direction, state.pulse_count)
    (ph, f, d, pc), ys = jax.lax.scan(step, init, None, length=n)
    new_state = SweepState(phase=ph, freq=f, direction=d, pulse_count=pc)
    return new_state, (amplitude * ys).astype(jnp.complex64)


def fm_broadcast(sample_rate: float, left, right, carrier_hz: float,
                 rds_bits=None, snr_db: float | None = None, seed: int = 0,
                 amplitude: float = 0.5):
    """Host-side FM stereo broadcast IQ (numpy complex64, one sample per
    audio sample given): the composite 0.45*(L+R)/2 + 0.1*pilot(19 kHz)
    + 0.45*(L-R)/2*sin(2*pilot) [+ 0.06*RDS biphase*cos(3*pilot)] at 75 kHz
    deviation, on a carrier at carrier_hz, plus complex Gaussian noise
    snr_db below the carrier power when given.

    left/right: program audio at sample_rate (arrays of one length, |x|<=1);
    rds_bits: the differentially encoded RDS bitstream (demod.rds), sent at
    1187.5 baud biphase on the 57 kHz subcarrier."""
    import numpy as np

    left = np.asarray(left, np.float64)
    right = np.asarray(right, np.float64)
    t = np.arange(len(left)) / sample_rate
    th = 2.0 * np.pi * 19000.0 * t
    comp = (0.45 * (left + right) / 2.0 + 0.1 * np.sin(th)
            + 0.45 * (left - right) / 2.0 * np.sin(2.0 * th))
    if rds_bits is not None:
        sym = np.asarray(rds_bits, np.float64) * 2.0 - 1.0
        pos = t * 1187.5
        idx = np.minimum(pos.astype(np.int64), len(sym) - 1)
        biphase = sym[idx] * np.where(pos - idx < 0.5, 1.0, -1.0)
        comp = comp + 0.06 * biphase * np.cos(3.0 * th)
    phase = 2.0 * np.pi * np.cumsum(75000.0 * comp) / sample_rate
    iq = amplitude * np.exp(1j * (2.0 * np.pi * carrier_hz * t + phase))
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        sigma = amplitude * np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
        iq = iq + sigma * (rng.standard_normal(len(t))
                           + 1j * rng.standard_normal(len(t)))
    return iq.astype(np.complex64)
