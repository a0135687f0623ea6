"""NCO mixer: tune a channel to baseband by complex phase-ramp multiply.

Capability parity with Mixer/NCO (pebblelib/mixer.cpp:48-81, nco.cpp:16-45) and
the oscillator half of CDownConvert (pebblelib/downconvert.cpp:257-325).

Design: the reference runs a per-sample recursive quadrature oscillator with
gain renormalization (OscGn = 1.95 - |osc|^2, mixer.cpp:61-67) because sin/cos
was slow on its CPU.  Here the exact phase ramp exp(-j*2*pi*f*n/fs) for the
whole block is one elementwise op, carrying only the fractional start phase
across blocks — numerically cleaner than the reference (no amplitude drift).

Precision: phases are accumulated modulo 1.0 in float32.  For long runs at
large n the product f*n would lose precision, so the per-block ramp is built
from a split-precision frequency (hi: exactly representable in 12 bits;
lo: residual), keeping phase error below ~1e-6 cycles for blocks <= 2^16.

Sign convention follows the reference (mixer.cpp:27-31): ``mix(x, +f)`` shifts
a component at +f Hz down to DC (multiplies by exp(-j*2*pi*f*t)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pebblesdr_tpu.core.block import pytree_dataclass

TWO_PI = 2.0 * jnp.pi
_SPLIT = 4096.0  # 2^12


@pytree_dataclass
class MixerState:
    phase: jax.Array  # [C] fractional cycles in [0,1)


def mixer_init(channels: int = 1) -> MixerState:
    return MixerState(phase=jnp.zeros((channels,), jnp.float32))


def split_freq(freq_hz, sample_rate):
    """Host-side: split normalized frequency into (hi, lo) float32 pair.

    hi is quantized to multiples of 2^-12 (exact in float32 for n < 2^12 blocks),
    lo is the small residual; n*hi and n*lo each stay full-precision.
    """
    import numpy as np

    f = float(freq_hz) / float(sample_rate)
    f = f - np.floor(f)
    hi = np.float32(np.round(f * _SPLIT) / _SPLIT)
    lo = np.float32(f - float(hi))
    # returned as numpy so callers can np.stack without an eager device op
    return hi, lo


def phase_ramp(phase0, n: int, f_hi, f_lo):
    """[C, n] fractional-cycle ramp starting at phase0 [C], step f_hi+f_lo [C]."""
    k = jnp.arange(n, dtype=jnp.float32)[None, :]
    # k*f_hi mod 1 computed with hi exactly on the 2^-12 grid: mod is exact.
    ramp = jnp.mod(k * f_hi[:, None], 1.0) + k * f_lo[:, None]
    return jnp.mod(phase0[:, None] + ramp, 1.0)


_CHUNK = 128  # oscillator factorization chunk


def oscillator(phase0: jax.Array, n: int, f_hi: jax.Array, f_lo: jax.Array):
    """exp(-j*2*pi*(phase0 + k*(f_hi+f_lo))) for k in [0, n) — factorized.

    The ramp splits as k = CHUNK*q + r, so osc[k] = coarse[q] * fine[r]:
    2*(n/CHUNK + CHUNK) transcendentals + one rank-1 outer product instead of
    2n transcendentals (sin/cos would otherwise be the mixer's cost).  Exact to float32: with f_hi on the
    2^-12 grid, r*f_hi and CHUNK*q*f_hi are exactly representable and the
    mod-1 reductions are exact; f_lo terms stay tiny.
    phase0/f_hi/f_lo: [C].  Returns complex64 [C, n].
    """
    c = phase0.shape[0]
    if n % _CHUNK:
        ph = phase_ramp(phase0, n, f_hi, f_lo)
        return jnp.exp(-1j * TWO_PI * ph).astype(jnp.complex64)
    q = n // _CHUNK
    r = jnp.arange(_CHUNK, dtype=jnp.float32)[None, :]
    fine_arg = jnp.mod(r * f_hi[:, None], 1.0) + r * f_lo[:, None]
    qs = jnp.arange(q, dtype=jnp.float32)[None, :] * float(_CHUNK)
    coarse_arg = (jnp.mod(qs * f_hi[:, None], 1.0) + qs * f_lo[:, None]
                  + phase0[:, None])
    fine = jnp.exp(-1j * TWO_PI * jnp.mod(fine_arg, 1.0))
    coarse = jnp.exp(-1j * TWO_PI * jnp.mod(coarse_arg, 1.0))
    return (coarse[:, :, None] * fine[:, None, :]).reshape(c, n).astype(jnp.complex64)


def mix(state: MixerState, x: jax.Array, f_hi, f_lo) -> tuple[MixerState, jax.Array]:
    """x: [C, N] complex64 -> tuned [C, N]; frequency as split pair (per split_freq).

    f_hi/f_lo may be scalars (all channels share a tune) or [C] arrays
    (per-channel tuning — the channelizer path).
    """
    n = x.shape[-1]
    f_hi = jnp.broadcast_to(jnp.asarray(f_hi, jnp.float32), state.phase.shape)
    f_lo = jnp.broadcast_to(jnp.asarray(f_lo, jnp.float32), state.phase.shape)
    osc = oscillator(state.phase, n, f_hi, f_lo)
    y = x * osc
    new_phase = jnp.mod(state.phase + jnp.mod(n * f_hi, 1.0) + n * f_lo, 1.0)
    return MixerState(phase=new_phase), y


def mix_simple(state: MixerState, x: jax.Array, freq_hz, sample_rate):
    """Convenience: traced scalar frequency without host-side split (slightly
    lower phase precision; fine for tests and slow retuning)."""
    f = jnp.asarray(freq_hz, jnp.float32) / sample_rate
    f = jnp.mod(f, 1.0)
    hi = jnp.round(f * _SPLIT) / _SPLIT
    lo = f - hi
    return mix(state, x, hi, lo)
