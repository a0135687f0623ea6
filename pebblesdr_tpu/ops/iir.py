"""IIR filters: first-order sections and biquads as parallel associative scans.

Capability parity with CIir (pebblelib/iir.{h,cpp}: LP/HP/BP/BR biquads, direct
form 2, real & complex process) plus the first-order IIRs scattered through the
reference (AM DC removal alpha=0.9999 demod_am.cpp, WFM de-emphasis, EWMA
averagers).

Design: a linear recurrence y[n] = a*y[n-1] + b[n] is associative —
elements (a, b) compose as (a2*a1, a2*b1 + b2) — so instead of a per-sample
loop we run jax.lax.associative_scan (O(log N) depth, fully vectorized).
Biquads lift to the same form with 2x2 state matrices.  State crossing block
boundaries is the filter's final internal state, re-injected as the scan seed.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core.precision import DOT_PRECISION


# ------------------------------------------------------------- first order

_fo_tables_cache: dict[tuple, tuple] = {}


def _first_order_chunk_tables(a: float, b: float, chunk: int):
    """Constant tables for the chunked-matmul one-pole: triangular kernel
    T[j, n] = b a^{n-j}, chunk-end row p[j] = b a^{L-1-j}, injection a^{n+1}."""
    key = (a, b, chunk)
    if key not in _fo_tables_cache:
        k = np.arange(chunk)
        pow_a = a ** k.astype(np.float64)
        idx = np.subtract.outer(np.arange(chunk), np.arange(chunk))  # n - j
        tt = np.where(idx >= 0, b * pow_a[np.abs(idx)], 0.0).T       # [j, n]
        p_end = b * pow_a[::-1]                                       # [L]
        inj = a * pow_a                                               # a^{n+1}
        with jax.ensure_compile_time_eval():
            _fo_tables_cache[key] = (
                jnp.asarray(tt, jnp.float32), jnp.asarray(p_end, jnp.float32),
                jnp.asarray(inj, jnp.float32), float(a ** chunk))
    return _fo_tables_cache[key]


def first_order_apply(y_prev: jax.Array, x: jax.Array, a, b):
    """y[n] = a*y[n-1] + b*x[n], fully parallel.

    Fast paths for static `a`:
      * N*(1-a) small: closed form
        y[n] = a^n * (y_prev*a + cumsum(b*x[k] * a^{-k}))  — one cumsum
        (the a^{-k} weights grow by e^{N(1-a)}; used only below e^10);
      * otherwise (float32, N a chunk multiple): chunked matmul — per-chunk
        zero-state response as one triangular [L, L] matmul, cross-chunk
        handoff as a cumsum-style scan over N/L scalars (same scheme as
        biquad_apply).
    Fallback: associative scan (O(log N) steps).

    y_prev: [C] previous output; x: [C, N] real or complex.
    Returns (y_last [C], y [C, N]).
    """
    n = x.shape[-1]
    if isinstance(a, (int, float)) and 0.0 < a < 1.0 and n * (1.0 - a) < 10.0:
        k = jnp.arange(n, dtype=jnp.float32)
        a_pow = jnp.exp(k * float(np.log(a))).astype(x.real.dtype)   # a^k
        a_inv = jnp.exp(-k * float(np.log(a))).astype(x.real.dtype)  # a^-k
        seed = (a * y_prev)[:, None].astype(x.dtype)
        terms = b * x * a_inv[None, :]
        y = a_pow[None, :] * (seed + jnp.cumsum(terms, axis=-1))
        return y[:, -1], y

    chunk = (_biquad_pick_chunk(n)
             if (isinstance(a, (int, float)) and isinstance(b, (int, float))
                 and 0.0 < a < 1.0 and x.dtype == jnp.float32) else None)
    if chunk is not None:
        tt, p_end, inj, a_l = _first_order_chunk_tables(float(a), float(b),
                                                        chunk)
        c = x.shape[0]
        k_n = n // chunk
        xc = x.reshape(c, k_n, chunk)
        y_zs = jnp.matmul(xc, tt, precision=DOT_PRECISION)       # [C, K, L]
        d = jnp.matmul(xc, p_end, precision=DOT_PRECISION)       # [C, K]
        # chunk-boundary handoff t_k = a^L t_{k-1} + d_k over K scalars
        _, t_end = _first_order_assoc(y_prev, d, a_l, 1.0)
        v_in = jnp.concatenate([y_prev[:, None], t_end[:, :-1]], axis=1)
        y = (y_zs + inj[None, None, :] * v_in[:, :, None]).reshape(c, n)
        return y[:, -1], y

    return _first_order_assoc(y_prev, x, a, b)


def _first_order_assoc(y_prev: jax.Array, x: jax.Array, a, b):
    """Associative-scan one-pole (general a/b, real or complex)."""
    a = jnp.asarray(a, x.real.dtype)
    bx = b * x
    bx = bx.at[:, 0].add(a * y_prev)
    a_seq = jnp.broadcast_to(a, x.shape).astype(x.dtype)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    _, y = jax.lax.associative_scan(combine, (a_seq, bx), axis=-1)
    return y[:, -1], y


def dc_removal_apply(y_prev: jax.Array, x: jax.Array, alpha=0.9999):
    """One-pole DC blocker: y[n] = x[n] - m[n], m[n] = alpha*m[n-1]+(1-alpha)*x[n]
    (Demod_AM DC removal capability, demod_am.cpp:36-64).  y_prev carries m."""
    m_last, m = first_order_apply(y_prev, x, alpha, 1.0 - alpha)
    return m_last, x - m


def dc_removal_chunked(y_prev: jax.Array, x: jax.Array, alpha=0.9999,
                      chunk: int = 512):
    """DC blocker for FULL-RATE streams: the DC estimate is piecewise-constant
    per `chunk` samples (per-chunk means, EWMA across chunks with the
    equivalent per-chunk coefficient alpha^chunk).  The estimate tracks a
    quantity that by definition moves on >> chunk timescales, so this is
    equivalent to the per-sample blocker while touching the big array only
    twice (mean + subtract) instead of running a length-N recurrence."""
    c, n = x.shape
    if n % chunk:
        return dc_removal_apply(y_prev, x, alpha)
    means = jnp.mean(x.reshape(c, n // chunk, chunk), axis=-1)
    a_c = float(alpha) ** chunk
    m_last, m = first_order_apply(y_prev, means, a_c, 1.0 - a_c)
    y = x - jnp.repeat(m, chunk, axis=-1)
    return m_last, y


# ------------------------------------------------------------- biquads

@dataclasses.dataclass(frozen=True)
class BiquadCoef:
    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def design_biquad(kind: str, f0_hz: float, sample_rate: float, q: float) -> BiquadCoef:
    """RBJ-cookbook biquad design: kinds 'lowpass'|'highpass'|'bandpass'|'notch'
    (CIir capability: LP/HP/BP/BR, iir.h:21-42)."""
    w0 = 2.0 * math.pi * f0_hz / sample_rate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    if kind == "lowpass":
        b0, b1, b2 = (1 - cw) / 2, 1 - cw, (1 - cw) / 2
    elif kind == "highpass":
        b0, b1, b2 = (1 + cw) / 2, -(1 + cw), (1 + cw) / 2
    elif kind == "bandpass":
        b0, b1, b2 = alpha, 0.0, -alpha
    elif kind == "notch":
        b0, b1, b2 = 1.0, -2 * cw, 1.0
    else:
        raise ValueError(kind)
    a0 = 1 + alpha
    return BiquadCoef(b0 / a0, b1 / a0, b2 / a0, (-2 * cw) / a0, (1 - alpha) / a0)


def biquad_state_init(channels: int, dtype=jnp.float32) -> jax.Array:
    """DF2 state [C, 2]: (w[n-1], w[n-2])."""
    return jnp.zeros((channels, 2), dtype)


_biquad_tables_cache: dict[tuple, tuple] = {}


def _biquad_chunk_tables(coef: BiquadCoef, chunk: int):
    """Constant tables for the chunked-matmul biquad (float64 on host).

    The DF2 state recurrence v[n] = M v[n-1] + e0 x[n] has constant M, so
    within a chunk of length L the zero-state response is a causal FIR with
    kernel phi[k] = (M^k)[0,0] — a lower-triangular [L, L] matmul — and the
    carried state enters through the constant injection rows of M^{n+1}.
    """
    key = (coef.b0, coef.b1, coef.b2, coef.a1, coef.a2, chunk)
    if key not in _biquad_tables_cache:
        m = np.array([[-coef.a1, -coef.a2], [1.0, 0.0]], np.float64)
        pows = np.empty((chunk + 1, 2, 2), np.float64)
        pows[0] = np.eye(2)
        for k in range(1, chunk + 1):
            pows[k] = m @ pows[k - 1]
        phi = pows[:chunk, 0, 0]                 # zero-state kernel, k=0..L-1
        idx = np.subtract.outer(np.arange(chunk), np.arange(chunk))  # n - j
        tt = np.where(idx >= 0, phi[np.abs(idx)], 0.0).T             # [j, n]
        p_end = pows[chunk - 1 - np.arange(chunk), :, 0]  # [L,2] M^{L-1-j} e0
        inj = pows[1:chunk + 1, 0, :]                     # [L,2] row0 of M^{n+1}
        a_l = pows[chunk]                                 # [2,2] M^L
        with jax.ensure_compile_time_eval():
            _biquad_tables_cache[key] = (
                jnp.asarray(tt, jnp.float32), jnp.asarray(p_end, jnp.float32),
                jnp.asarray(inj, jnp.float32), jnp.asarray(a_l, jnp.float32))
    return _biquad_tables_cache[key]


def _biquad_pick_chunk(n: int) -> int | None:
    for chunk in (512, 256, 128):
        if n % chunk == 0 and n > chunk:
            return chunk
    return None


def biquad_apply(state: jax.Array, x: jax.Array, coef: BiquadCoef):
    """Direct-form-2 biquad over [C, N].

    w[n] = x[n] - a1 w[n-1] - a2 w[n-2];  y[n] = b0 w[n] + b1 w[n-1] + b2 w[n-2].
    Complex inputs filter re/im independently (linear filter).

    Fast path (float32, N a multiple of the chunk size): chunked matmul —
    per-chunk zero-state response as one lower-triangular [L, L] matmul,
    cross-chunk state handoff as a tiny associative scan over N/L chunks with
    the constant transfer matrix M^L.  O(N·L) matmul MACs beat the
    O(N log N) 2x2-einsum associative scan in compile time.
    Fallback: the associative matrix scan (exact same math).
    """
    if jnp.iscomplexobj(x):
        s_r, y_r = biquad_apply(state.real, x.real, coef)
        s_i, y_i = biquad_apply(state.imag, x.imag, coef)
        return jax.lax.complex(s_r, s_i), jax.lax.complex(y_r, y_i)

    c, n = x.shape
    chunk = _biquad_pick_chunk(n) if x.dtype == jnp.float32 else None
    if chunk is None:
        return _biquad_apply_scan(state, x, coef)

    tt, p_end, inj, a_l = _biquad_chunk_tables(coef, chunk)
    k = n // chunk
    xc = x.reshape(c, k, chunk)
    # zero-state response + zero-state chunk-end state, both matmuls
    w_zs = jnp.matmul(xc, tt, precision=DOT_PRECISION)          # [C, K, L]
    d = jnp.matmul(xc, p_end, precision=DOT_PRECISION)          # [C, K, 2]
    # cross-chunk handoff: t_k = M^L t_{k-1} + d_k, t_{-1} = state.  The
    # error of this tiny 2x2 recurrence compounds multiplicatively across
    # the K chunks of a long stream (high-Q poles near |z|=1 amplify it)
    d = d.at[:, 0, :].add(jnp.einsum("ij,cj->ci", a_l, state,
                                     precision=DOT_PRECISION))
    mats = jnp.broadcast_to(a_l, (c, k, 2, 2))

    def combine(l, r):
        ml, bl = l
        mr, br = r
        return (jnp.einsum("...ij,...jk->...ik", mr, ml,
                           precision=DOT_PRECISION),
                jnp.einsum("...ij,...j->...i", mr, bl,
                           precision=DOT_PRECISION) + br)

    _, t_end = jax.lax.associative_scan(combine, (mats, d), axis=1)  # [C,K,2]
    v_in = jnp.concatenate([state[:, None, :], t_end[:, :-1, :]], axis=1)
    w = (w_zs + jnp.einsum("nv,ckv->ckn", inj, v_in,
                           precision=DOT_PRECISION)).reshape(c, n)
    w1 = jnp.concatenate([state[:, :1], w[:, :-1]], axis=-1)
    w2 = jnp.concatenate([state[:, 1:2], w1[:, :-1]], axis=-1)
    y = coef.b0 * w + coef.b1 * w1 + coef.b2 * w2
    return jnp.stack([w[:, -1], w[:, -2]], axis=-1), y


def _biquad_apply_scan(state: jax.Array, x: jax.Array, coef: BiquadCoef):
    """Associative 2x2 matrix-scan biquad (reference formulation)."""
    c, n = x.shape
    dt = x.dtype
    m = jnp.asarray([[-coef.a1, -coef.a2], [1.0, 0.0]], dt)           # [2,2]
    ms = jnp.broadcast_to(m, (c, n, 2, 2))
    bvec = jnp.stack([x, jnp.zeros_like(x)], axis=-1)                  # [C,N,2]
    # fold carried state into first element: b0' = M @ v_prev + [x0, 0]
    bvec = bvec.at[:, 0, :].add(jnp.einsum("ij,cj->ci", m, state,
                                           precision=DOT_PRECISION))

    def combine(l, r):
        ml, bl = l
        mr, br = r
        return jnp.einsum("...ij,...jk->...ik", mr, ml,
                          precision=DOT_PRECISION), jnp.einsum(
            "...ij,...j->...i", mr, bl, precision=DOT_PRECISION) + br

    _, v = jax.lax.associative_scan(combine, (ms, bvec), axis=1)       # [C,N,2]
    w = v[..., 0]
    w1 = jnp.concatenate([state[:, :1], w[:, :-1]], axis=-1)
    w2 = jnp.concatenate([state[:, 1:2], w1[:, :-1]], axis=-1)
    y = coef.b0 * w + coef.b1 * w1 + coef.b2 * w2
    return v[:, -1, :], y


def deemphasis_alpha(tau_us: float, sample_rate: float) -> float:
    """De-emphasis one-pole coefficient for 75us (US) / 50us (EU) FM audio."""
    return math.exp(-1.0 / (tau_us * 1e-6 * sample_rate))
