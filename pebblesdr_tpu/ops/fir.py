"""FIR design (host, float64/scipy) and streaming FIR apply (device, XLA conv).

Covers the capabilities of the reference FIR family:
  * CFir Kaiser LP/HP design + complex Hilbert bandpass via coefficient shift
    (pebblelib/fir.h:36-43, fir.cpp InitLPFilter/GenerateHBFilter)
  * FIRFilter windowed-sinc LOWPASS/HIGHPASS/BANDPASS/BANDSTOP
    (pebblelib/firfilter.h:9-60)
  * the per-stage overlap-save convolution of HalfbandFilter::convolveOS
    (pebblelib/decimator.cpp:323-378) — here the carried tail + XLA conv.

Design: streaming state is an explicit [C, T-1] input tail carried
across blocks (the reference keeps a malloc'd lastX buffer per filter object);
the convolution itself is one lax.conv_general_dilated over the whole block —
real taps process re/im as a batch, complex taps use a 2x2 real filter bank.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal

from pebblesdr_tpu.core import windows as win
from pebblesdr_tpu.core.precision import DOT_PRECISION


# ---------------------------------------------------------------- design (host)

def design_lowpass_kaiser(cutoff_hz: float, sample_rate: float, atten_db: float = 60.0,
                          transition_hz: float | None = None, max_taps: int = 127) -> np.ndarray:
    """Kaiser-windowed LP (CFir::InitLPFilter capability)."""
    if transition_hz is None:
        transition_hz = max(0.1 * cutoff_hz, 0.02 * sample_rate)
    ntaps, beta = scipy.signal.kaiserord(atten_db, transition_hz / (0.5 * sample_rate))
    ntaps = min(ntaps | 1, max_taps)  # odd, bounded
    return scipy.signal.firwin(ntaps, cutoff_hz, window=("kaiser", beta), fs=sample_rate)


def design_cfir_kaiser_lp(astop_db: float, fpass_hz: float, fstop_hz: float,
                          sample_rate: float) -> np.ndarray:
    """CFir::InitLPFilter's EXACT Kaiser design (fir.cpp:~InitLPFilter):
    beta from the standard Kaiser attenuation formula, tap count from the
    (Astop-8)/(2.285*2pi*dF) estimate, sinc at the (pass+stop)/2 6 dB
    cutoff.  Used where reference-exact filter shapes matter (SAM rails
    parity vs the compiled reference)."""
    norm_pass = fpass_hz / sample_rate
    norm_stop = fstop_hz / sample_rate
    norm_cut = (norm_stop + norm_pass) / 2.0
    if astop_db < 20.96:
        beta = 0.0
    elif astop_db >= 50.0:
        beta = 0.1102 * (astop_db - 8.71)
    else:
        beta = (0.5842 * (astop_db - 20.96) ** 0.4
                + 0.07886 * (astop_db - 20.96))
    ntaps = int((astop_db - 8.0)
                / (2.285 * 2.0 * np.pi * (norm_stop - norm_pass)) + 1)
    ntaps = max(3, ntaps)
    n = np.arange(ntaps, dtype=np.float64)
    fc = 0.5 * (ntaps - 1)
    x = n - fc
    c = np.where(x == 0.0, 2.0 * norm_cut,
                 np.sin(2.0 * np.pi * x * norm_cut)
                 / (np.pi * np.where(x == 0.0, 1.0, x)))
    xk = (n - (ntaps - 1) / 2.0) / ((ntaps - 1) / 2.0)
    w = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - xk * xk))) / np.i0(beta)
    return c * w


def design_rail_pair(h: np.ndarray, center_hz: float,
                     sample_rate: float) -> tuple[np.ndarray, np.ndarray]:
    """CFir::GenerateHBFilter's rail pair: (2h cos, 2h sin) shifted by
    center_hz.  The reference applies these INDEPENDENTLY to the re/im
    rails (CFir::ProcessFilter CPX overload filters re with ICoef and im
    with QCoef — the phasing method, NOT a complex convolution)."""
    ntaps = len(h)
    x = np.arange(ntaps, dtype=np.float64) - 0.5 * (ntaps - 1)
    ang = 2.0 * np.pi * (center_hz / sample_rate) * x
    return 2.0 * h * np.cos(ang), 2.0 * h * np.sin(ang)


def design_windowed_sinc(ntaps: int, cutoff_hz: float, sample_rate: float,
                         kind: win.WindowType = win.WindowType.BLACKMAN_NUTTALL) -> np.ndarray:
    """Windowed-sinc LP, the FastFIR prototype (fastfir.cpp:231-250 semantics)."""
    fc = cutoff_hz / sample_rate  # cycles/sample
    n = np.arange(ntaps, dtype=np.float64)
    x = n - 0.5 * (ntaps - 1)
    w = win.window(kind, ntaps, periodic=False)
    h = np.where(x == 0.0, 2.0 * fc, np.sin(2.0 * np.pi * fc * x) / (np.pi * np.where(x == 0, 1.0, x)))
    return h * w


def shift_to_bandpass(h: np.ndarray, center_hz: float, sample_rate: float) -> np.ndarray:
    """LP taps -> complex bandpass taps centered at center_hz (CFastFIR /
    GenerateHBFilter capability: multiply by exp(j*2*pi*fc*x))."""
    ntaps = len(h)
    x = np.arange(ntaps, dtype=np.float64) - 0.5 * (ntaps - 1)
    return h * np.exp(2j * np.pi * (center_hz / sample_rate) * x)


def design_bandpass_complex(lo_hz: float, hi_hz: float, sample_rate: float, ntaps: int,
                            kind: win.WindowType = win.WindowType.BLACKMAN_NUTTALL) -> np.ndarray:
    """Arbitrary complex bandpass (lo..hi may span negative freqs), FastFIR-style."""
    assert hi_hz > lo_hz
    half_bw = (hi_hz - lo_hz) / 2.0
    center = (hi_hz + lo_hz) / 2.0
    lp = design_windowed_sinc(ntaps, half_bw, sample_rate, kind)
    return shift_to_bandpass(lp, center, sample_rate)


def design_hilbert(ntaps: int, center_hz: float, bw_hz: float, sample_rate: float) -> np.ndarray:
    """Complex analytic bandpass (Hilbert pair) — CFir::GenerateHBFilter analog,
    used by SAM (demod_sam.cpp:36) and WFM stereo (demod_wfm.cpp:269)."""
    lp = design_windowed_sinc(ntaps, bw_hz / 2.0, sample_rate)
    return 2.0 * shift_to_bandpass(lp, center_hz, sample_rate)


def design_halfband(ntaps: int, wpass: float) -> np.ndarray:
    """Equiripple halfband decimation filter.

    wpass is the alias-free bandwidth as a fraction of the input sample rate
    (same spec as the reference's Matlab-designed table, decimator.h:152-171:
    taps {7,11,...,51,55} with wpass {.0030,.0500,...,.3332,.4000}).
    Designed here with remez + the halfband constraint (even taps zeroed).
    """
    assert ntaps % 2 == 1
    fp = wpass / 2.0  # passband edge in cycles/sample
    h = scipy.signal.remez(ntaps, [0.0, fp, 0.5 - fp, 0.5], [1.0, 0.0], fs=1.0)
    # enforce exact halfband structure: odd-indexed (from center) taps are zero
    center = ntaps // 2
    for i in range(ntaps):
        if i != center and (i - center) % 2 == 0:
            h[i] = 0.0
    h[center] = 0.5
    # normalize DC gain to exactly 1
    return h / np.sum(h)


CIC3_TAPS = np.array([1.0, 3.0, 3.0, 1.0]) / 8.0  # CIC3 comb as FIR (decim 2)


# ---------------------------------------------------------------- apply (device)

def _conv_real(x2: jax.Array, taps: jax.Array, stride: int) -> jax.Array:
    """x2: [B, L] float32, taps [T] -> valid correlation-with-flipped-taps
    (true convolution), strided.  Output [B, (L-T)//stride + 1]."""
    lhs = x2[:, None, :]
    rhs = taps[::-1][None, None, :].astype(jnp.float32)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"), precision=DOT_PRECISION,
    )
    return out[:, 0, :]


def fir_decimate2_polyphase(x: jax.Array, taps_np: np.ndarray, tail: jax.Array):
    """Streaming decimate-by-2 FIR via polyphase even/odd split — the fast
    path for halfband stages: coefficients are STATIC (numpy), zero taps are
    skipped entirely, and the convolution becomes (T+1)/2 shifted
    multiply-adds that XLA fuses into one pass (no im2col / conv lowering).

    Bit-identical to fir_apply(x, taps, tail, decim=2):
      y[m] = sum_j h[j] * xx[2m + T-1 - j],  xx = [tail | x].
    """
    c, n = x.shape
    t = len(taps_np)
    m = n // 2
    xx = jnp.concatenate([tail, x], axis=-1)           # [C, N+T-1]
    xr = jnp.concatenate([xx.real, xx.imag], axis=0)   # [2C, L]
    if xr.shape[-1] % 2:
        xr = jnp.pad(xr, ((0, 0), (0, 1)))
    half = xr.reshape(2 * c, -1, 2)
    xe, xo = half[:, :, 0], half[:, :, 1]
    acc = None
    for j in range(t):
        h = float(taps_np[j])
        if h == 0.0:
            continue
        idx = t - 1 - j
        src = xe if (idx & 1) == 0 else xo
        off = idx // 2
        term = h * jax.lax.slice_in_dim(src, off, off + m, axis=1)
        acc = term if acc is None else acc + term
    y = jax.lax.complex(acc[:c], acc[c:]).astype(jnp.complex64)
    new_tail = xx[:, -(t - 1):] if t > 1 else jnp.zeros((c, 0), x.dtype)
    return y, new_tail


def fir_apply(x: jax.Array, taps: jax.Array, tail: jax.Array, decim: int = 1):
    """Streaming FIR: x [C, N] complex64, real taps [T], tail [C, T-1] complex64.

    Returns (y [C, N//decim], new_tail).  y[m] = sum_k h[k] * xin[m*decim - k]
    where xin is the tail-extended stream — i.e. standard causal convolution
    with state carried across blocks (convolveOS semantics, decimator.cpp:323).
    """
    c, n = x.shape
    t = taps.shape[0]
    xx = jnp.concatenate([tail, x], axis=-1)  # [C, N+T-1]
    xr = jnp.concatenate([xx.real, xx.imag], axis=0)  # [2C, N+T-1]
    yr = _conv_real(xr, taps, decim)  # [2C, N//decim]
    y = jax.lax.complex(yr[:c], yr[c:]).astype(jnp.complex64)
    new_tail = xx[:, -(t - 1):] if t > 1 else jnp.zeros((c, 0), x.dtype)
    return y, new_tail


def fir_apply_complex(x: jax.Array, taps_c: jax.Array, tail: jax.Array,
                      decim: int = 1,
                      taps_np: np.ndarray | None = None):
    """Streaming FIR with complex taps (Hilbert / shifted bandpass).

    Pass taps_np (static numpy complex) to take the banded-matmul fast
    path: the complex product needs each real input row against BOTH tap
    sets, which is exactly fir_apply_real_signal_pair on the stacked
    [re; im] rows — ONE window stack, one matmul.
    Fallback: one conv with a [2out, 2in, T] real filter bank.
    """
    c, n = x.shape
    if taps_np is not None and decim == 1:
        h = np.asarray(taps_np)
        rows = jnp.concatenate([x.real, x.imag], axis=0)        # [2C, N]
        tail2 = jnp.concatenate([tail.real, tail.imag], axis=0)
        ya, yb, tail_rows = fir_apply_real_signal_pair(
            rows, tail2, h.real.astype(np.float32),
            h.imag.astype(np.float32))
        # (xr + j xi)(hr + j hi): re = xr*hr - xi*hi, im = xr*hi + xi*hr
        y = jax.lax.complex(ya[:c] - yb[c:], yb[:c] + ya[c:])
        new_tail = jax.lax.complex(tail_rows[:c], tail_rows[c:])
        return y.astype(jnp.complex64), new_tail.astype(tail.dtype)
    t = taps_c.shape[0]
    xx = jnp.concatenate([tail, x], axis=-1)
    lhs = jnp.stack([xx.real, xx.imag], axis=1)  # [C, 2, L]
    hr = taps_c.real[::-1].astype(jnp.float32)
    hi = taps_c.imag[::-1].astype(jnp.float32)
    rhs = jnp.stack([
        jnp.stack([hr, -hi], axis=0),  # out 0 = re
        jnp.stack([hi, hr], axis=0),   # out 1 = im
    ], axis=0)  # [2, 2, T]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(decim,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"), precision=DOT_PRECISION,
    )  # [C, 2, M]
    y = jax.lax.complex(out[:, 0, :], out[:, 1, :]).astype(jnp.complex64)
    new_tail = xx[:, -(t - 1):] if t > 1 else jnp.zeros((c, 0), x.dtype)
    return y, new_tail


_banded_cache: dict[tuple, np.ndarray] = {}
_BANDED_MAX_ENTRIES = 4_000_000


def banded_fir_matrix(taps_np: np.ndarray, n: int, decim: int = 1) -> np.ndarray:
    """[N+T-1, N//decim] banded operator: y = x_ext @ B == causal FIR.
    Static-taps fast path for small demod-rate blocks: one matmul."""
    key = (taps_np.tobytes(), n, decim)
    if key not in _banded_cache:
        t = len(taps_np)
        m = n // decim
        b = np.zeros((n + t - 1, m), np.float32)
        for out_i in range(m):
            base = out_i * decim
            for j in range(t):
                b[base + t - 1 - j, out_i] = taps_np[j]
        # device array: lifted as a jit parameter, not an HLO literal;
        # ensure_compile_time_eval keeps it concrete even when first touched
        # inside a jit trace
        with jax.ensure_compile_time_eval():
            _banded_cache[key] = jnp.asarray(b)
    return _banded_cache[key]


def _banded_seg(n: int, t: int, decim: int) -> int:
    """Segment length for the windowed long-input FIR path; 0 if none fits.

    Total MACs = (n/decim outputs) x (seg+T-1 read rows), so the SMALLEST
    segment wins on FLOPs — but a matmul with fewer than 64 output columns
    (seg/decim) is too narrow to run efficiently.  Pick the smallest segment
    meeting both; at decim >= 4 this cuts the dense-band waste ~7x vs
    always-2048."""
    for seg in (256, 512, 1024, 2048):
        if (n % seg == 0 and seg % decim == 0 and seg >= t
                and seg // decim >= 64
                and (seg + t - 1) * (seg // decim) <= _BANDED_MAX_ENTRIES):
            return seg
    for seg in (2048, 1024, 512):  # fallback: original preference
        if (n % seg == 0 and seg % decim == 0 and seg >= t
                and (seg + t - 1) * (seg // decim) <= _BANDED_MAX_ENTRIES):
            return seg
    return 0


def fir_apply_real_signal(x: jax.Array, taps: jax.Array, tail: jax.Array,
                          decim: int = 1, taps_np: np.ndarray | None = None):
    """Streaming FIR on a real float32 signal [C, N] (audio-path filters).

    Pass taps_np (static numpy) to enable the banded-matmul fast path for
    small blocks; falls back to XLA conv otherwise (identical math).
    """
    t = taps.shape[0] if taps is not None else len(taps_np)
    xx = jnp.concatenate([tail, x], axis=-1)
    n = x.shape[-1]
    if (taps_np is not None
            and (n + t - 1) * (n // decim) <= _BANDED_MAX_ENTRIES):
        b = jnp.asarray(banded_fir_matrix(np.asarray(taps_np, np.float32), n, decim))
        y = jnp.matmul(xx, b, precision=DOT_PRECISION)
    elif taps_np is not None and _banded_seg(n, t, decim):
        # long input (a batched multi-block stream): window into segments and
        # run ONE batched matmul against the per-segment banded operator —
        # identical math
        seg = _banded_seg(n, t, decim)
        c = x.shape[0]
        k = n // seg
        b = jnp.asarray(banded_fir_matrix(np.asarray(taps_np, np.float32),
                                          seg, decim))
        # windows[i] = xx[:, i*seg : i*seg+seg+T-1] -> [C, K, seg+T-1] from
        # two contiguous reshapes + one concat (_banded_seg guarantees
        # seg >= T): the K-long unrolled slice+stack it replaces cost O(K)
        # ops plus [K, C, ·] relayouts around the matmul
        base = xx[:, :n].reshape(c, k, seg)
        if t > 1:
            carry = x.reshape(c, k, seg)[:, :, seg - (t - 1):]
            wins = jnp.concatenate([base, carry], axis=-1)
        else:
            wins = base
        y = jnp.matmul(wins, b, precision=DOT_PRECISION)   # [C, K, seg//decim]
        y = y.reshape(c, n // decim)
    else:
        y = _conv_real(xx, taps if taps is not None
                       else jnp.asarray(taps_np, jnp.float32), decim)
    new_tail = xx[:, -(t - 1):] if t > 1 else jnp.zeros((x.shape[0], 0), x.dtype)
    return y, new_tail


def fir_apply_real_signal_pair(x: jax.Array, tail: jax.Array,
                               taps_a_np: np.ndarray, taps_b_np: np.ndarray,
                               decim: int = 1):
    """TWO static-tap FIRs over the same real stream in ONE banded matmul.

    The window stack (the dominant traffic for long streams) is built once
    and multiplied against [B_a | B_b] — the complex-tap decimation case
    (a real composite filtered by re/im tap sets) pays one pass over the
    input instead of two.  x: [C, N] float32; taps equal length.
    Returns (y_a [C, N//decim], y_b, new_tail)."""
    t = len(taps_a_np)
    assert len(taps_b_np) == t
    xx = jnp.concatenate([tail, x], axis=-1)
    c, n = x.shape
    m = n // decim
    seg = _banded_seg(n, t, decim)
    key = (taps_a_np.tobytes(), taps_b_np.tobytes(), seg or n, decim)
    if key not in _banded_cache:
        ln = seg or n
        b2 = np.concatenate(
            [np.asarray(banded_fir_matrix(np.asarray(taps_a_np, np.float32),
                                          ln, decim)),
             np.asarray(banded_fir_matrix(np.asarray(taps_b_np, np.float32),
                                          ln, decim))], axis=1)
        with jax.ensure_compile_time_eval():
            _banded_cache[key] = jnp.asarray(b2)
    b = _banded_cache[key]
    if seg:
        k = n // seg
        base = xx[:, :n].reshape(c, k, seg)
        if t > 1:
            carry = x.reshape(c, k, seg)[:, :, seg - (t - 1):]
            wins = jnp.concatenate([base, carry], axis=-1)
        else:
            wins = base
        y = jnp.matmul(wins, b, precision=DOT_PRECISION)   # [C, K, 2*seg//decim]
        ms = seg // decim
        y_a = y[:, :, :ms].reshape(c, m)
        y_b = y[:, :, ms:].reshape(c, m)
    else:
        y = jnp.matmul(xx, b, precision=DOT_PRECISION)     # [C, 2M]
        y_a, y_b = y[:, :m], y[:, m:]
    new_tail = xx[:, -(t - 1):] if t > 1 else jnp.zeros((c, 0), x.dtype)
    return y_a, y_b, new_tail


def fir_tail_init(channels: int, ntaps: int, dtype=jnp.complex64) -> jax.Array:
    return jnp.zeros((channels, max(ntaps - 1, 0)), dtype)
