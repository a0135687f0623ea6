"""Fractional resampler: windowed-sinc rate conversion (demod rate -> audio rate).

Capability parity with CFractResampler (pebblelib/fractresampler.{h,cpp}):
Blackman-Harris windowed-sinc interpolation with per-output fractional phase
(Init :87-137, Resample :146-187), the final audio-rate stage of the chain
(receiver.cpp:998-1004).

Design: the reference walks a float time accumulator through the
input doing a 28-tap MAC per output against a 280k-entry quantized sinc table
(flagged as the most expensive stage, receiver.cpp:998).  Here the rate ratio
is static per chain config, so the whole geometry is computed at build time:

  * output count M per input block N is exact (planner enforces N*out%in==0),
    so the fractional-phase pattern repeats identically every block — the
    gather indices [M, K] and coefficient matrix [M, K] are compile-time
    constants (coefficients evaluated exactly in float64, no table
    quantization — cleaner than the reference);
  * the kernel is one gather + elementwise multiply + reduce over K, batched
    over channels; streaming state is just the last K input samples.

Works for real (audio) and complex (IQ) signals alike.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core import windows as win
from pebblesdr_tpu.core.precision import DOT_PRECISION


@dataclasses.dataclass(frozen=True)
class ResamplePlan:
    in_rate: float
    out_rate: float
    n_in: int
    n_out: int
    taps: int
    gather_idx: np.ndarray  # [M, K] int32 indices into tail-extended input
    coefs: np.ndarray       # [M, K] float32
    dense: np.ndarray = None  # [K + N_in, M] banded matrix (matmul path)


def output_block(in_rate: int, out_rate: int, n_in: int) -> int:
    """Exact output block length, or raise if the geometry isn't rational."""
    m = Fraction(n_in) * Fraction(int(out_rate), int(in_rate))
    if m.denominator != 1:
        raise ValueError(
            f"n_in={n_in} not compatible with {in_rate}->{out_rate}; "
            f"need n_in divisible by {Fraction(int(in_rate), int(out_rate)).numerator}"
        )
    return int(m)


def plan(in_rate: int, out_rate: int, n_in: int, taps: int = 32) -> ResamplePlan:
    k = int(taps)
    m_out = output_block(in_rate, out_rate, n_in)
    step = Fraction(int(in_rate), int(out_rate))  # input samples per output
    ms = np.arange(m_out, dtype=np.float64)
    tau = ms * float(step)                    # exact in float64 for m < 2^40
    idx = np.floor(tau).astype(np.int64)
    frac = tau - idx

    j = np.arange(k, dtype=np.float64)
    # input sample offsets s_j = idx - K + 1 + j (the K most recent samples)
    # kernel argument u_j = frac + K/2 - j  (output delayed by K/2-1 samples)
    u = frac[:, None] + (k / 2.0) - j[None, :]
    fc = 0.5 * min(1.0, out_rate / in_rate)   # anti-alias cutoff (cycles/in-sample)
    core = 2.0 * fc * np.sinc(2.0 * fc * u)
    # Blackman-Harris window over the kernel support (fractresampler.cpp:52-59
    # uses the same family); evaluate continuously.
    wu = np.clip((u / (k / 2.0 + 1.0) + 1.0) / 2.0, 0.0, 1.0)  # -> [0,1]
    coeffs = win._COSINE_SUM[win.WindowType.BLACKMAN_HARRIS]
    wwin = np.zeros_like(wu)
    for kk, a in enumerate(coeffs):
        wwin += ((-1.0) ** kk) * a * np.cos(kk * 2.0 * np.pi * wu)
    kern = core * wwin
    # exact unity DC gain per output phase
    kern = kern / np.sum(kern, axis=1, keepdims=True)

    gather = (idx[:, None] - k + 1 + j[None, :].astype(np.int64)) + k  # tail offset
    assert gather.min() >= 0 and gather.max() < n_in + k
    # dense banded operator: y = x_ext @ dense (one [L, M] matmul in place
    # of a per-output gather)
    dense = np.zeros((n_in + k, m_out), np.float32)
    for mm in range(m_out):
        dense[gather[mm], mm] = kern[mm]
    return ResamplePlan(float(in_rate), float(out_rate), n_in, m_out, k,
                        gather.astype(np.int32), kern.astype(np.float32),
                        dense)


def state_init(p: ResamplePlan, channels: int, dtype=jnp.float32) -> jax.Array:
    return jnp.zeros((channels, p.taps), dtype)


_dense_cache: dict[int, jax.Array] = {}


def _dense_dev(p: ResamplePlan) -> jax.Array:
    """Banded operator as a cached DEVICE array (lifted as a jit parameter
    instead of an HLO literal).

    Keyed by the plan GEOMETRY, never id(): a garbage-collected plan's id
    can be reused by a different plan's array, silently serving the wrong
    operator (shape-mismatch at best)."""
    key = (p.in_rate, p.out_rate, p.n_in, p.taps)
    if key not in _dense_cache:
        with jax.ensure_compile_time_eval():
            _dense_cache[key] = jnp.asarray(p.dense)
    return _dense_cache[key]


def apply(p: ResamplePlan, state: jax.Array, x: jax.Array):
    """x: [C, N_in] (real or complex) -> (state', y [C, N_out]).

    Matmul path: the whole resampler is one [C, K+N] x [K+N, M] matmul against
    the static banded operator (identical math to the gather+MAC form).
    """
    xx = jnp.concatenate([state, x], axis=-1)            # [C, K+N]
    dense = _dense_dev(p)
    if jnp.iscomplexobj(xx):
        y = jax.lax.complex(
            jnp.matmul(xx.real, dense, precision=DOT_PRECISION),
            jnp.matmul(xx.imag, dense, precision=DOT_PRECISION))
    else:
        y = jnp.matmul(xx, dense, precision=DOT_PRECISION)
    new_state = xx[:, -p.taps:]
    return new_state, y.astype(x.dtype)


def apply_many(p: ResamplePlan, state: jax.Array, x_cat: jax.Array):
    """K consecutive blocks in ONE batched matmul against the PER-BLOCK
    banded operator — numerically identical to K sequential apply() calls
    (the fractional-time pattern is periodic per block, so every block uses
    the same operator).  x_cat: [C, K*n_in] -> (state', y [C, K*n_out]).
    Unlike plan(n_in=K*blk) (whose dense operator grows as K^2 and is
    untenable past a few blocks), memory here stays K-linear."""
    c, l = x_cat.shape
    k = l // p.n_in
    ext = jnp.concatenate([state, x_cat], axis=-1)      # [C, taps + K*N]
    # windows[k] = ext[:, k*N : k*N + N + taps] -> [C, K, N + taps], built
    # from two contiguous reshapes + one concat when taps <= N (always true
    # for the chain's audio geometry) — the K-long unrolled slice+stack it
    # replaces cost O(K) ops plus [K, C, ·] relayouts around the matmul.
    if p.taps <= p.n_in:
        base = ext[:, :l].reshape(c, k, p.n_in)
        # ext[(k+1)*N : (k+1)*N + taps] == x_cat block k's last `taps`
        carry = x_cat.reshape(c, k, p.n_in)[:, :, p.n_in - p.taps:]
        wins = jnp.concatenate([base, carry], axis=-1)  # [C, K, N + taps]
    else:
        wins = jnp.stack([jax.lax.slice_in_dim(ext, i * p.n_in,
                                               i * p.n_in + p.n_in + p.taps,
                                               axis=1) for i in range(k)],
                         axis=1)
    dense = _dense_dev(p)
    if jnp.iscomplexobj(ext):
        y = jax.lax.complex(
            jnp.matmul(wins.real, dense, precision=DOT_PRECISION),
            jnp.matmul(wins.imag, dense, precision=DOT_PRECISION))
    else:
        y = jnp.matmul(wins, dense, precision=DOT_PRECISION)  # [C, K, M]
    y = y.reshape(c, k * p.n_out)
    return ext[:, -p.taps:], y.astype(x_cat.dtype)


def apply_gather(p: ResamplePlan, state: jax.Array, x: jax.Array):
    """Reference gather+MAC formulation (kept for parity testing)."""
    xx = jnp.concatenate([state, x], axis=-1)
    gathered = xx[:, jnp.asarray(p.gather_idx)]          # [C, M, K]
    coefs = jnp.asarray(p.coefs)
    y = jnp.sum(gathered * coefs[None, :, :], axis=-1)
    return xx[:, -p.taps:], y.astype(x.dtype)
