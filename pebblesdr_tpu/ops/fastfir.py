"""FastFIR: FFT overlap-save complex bandpass — the main channel filter.

Capability parity with CFastFIR (pebblelib/fastfir.{h,cpp}):
  * arbitrary complex bandpass anywhere in -fs/2..fs/2, built from a
    Blackman-Nuttall windowed-sinc LP shifted by (hi+lo)/2, optional CW offset
    (SetupParameters, fastfir.cpp:191-272);
  * streaming overlap-save: FFT(2B) -> bin multiply by pre-FFT'd coefficients
    -> IFFT, emit B samples, carry B-sample input overlap
    (ProcessData, fastfir.cpp:281-319; CpxMpy :325-334).

Design: the whole [channels, 2B] batch goes through one jnp.fft.fft
(XLA's batched FFT), the mask multiply fuses into the surrounding elementwise
ops, and the carried overlap is an explicit [C, B] state array.  The reference
accumulates input to 2048 before each FFT; here the chain planner fixes the
block length to B so every step does exactly one FFT round — no data-dependent
buffering inside jit.

The mask is a runtime input (not baked into the compiled graph) so retuning the
passband never recompiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core import windows as win
from pebblesdr_tpu.ops import fir


def design_mask(lo_hz: float, hi_hz: float, sample_rate: float, block: int,
                offset_hz: float = 0.0) -> np.ndarray:
    """Frequency-domain filter mask [2*block] complex64 for overlap-save.

    Equivalent capability to CFastFIR::SetupParameters (fastfir.cpp:191-272):
    (block+1)-tap Blackman-Nuttall windowed-sinc LP, shifted to the passband
    center; returned already FFT'd.  lo/hi may be negative (LSB filters).
    """
    lo = lo_hz + offset_hz
    hi = hi_hz + offset_hz
    nyq = sample_rate / 2.0
    lo = max(lo, -nyq + 1.0)
    hi = min(hi, nyq - 1.0)
    assert hi > lo, f"bad bandpass {lo_hz}..{hi_hz}"
    fft_size = 2 * block
    ntaps = block + 1
    taps = fir.design_bandpass_complex(lo, hi, sample_rate, ntaps,
                                       kind=win.WindowType.BLACKMAN_NUTTALL)
    buf = np.zeros(fft_size, dtype=np.complex128)
    buf[:ntaps] = taps
    return np.fft.fft(buf).astype(np.complex64)


def state_init(channels: int, block: int) -> jax.Array:
    return jnp.zeros((channels, block), jnp.complex64)


def apply(state: jax.Array, x: jax.Array, mask: jax.Array):
    """Overlap-save step.  x: [C, B], state: [C, B] (previous input block),
    mask: [2B] complex64.  Returns (new_state, y [C, B])."""
    xx = jnp.concatenate([state, x], axis=-1)          # [C, 2B]
    spec = jnp.fft.fft(xx, axis=-1)
    filtered = jnp.fft.ifft(spec * mask[None, :], axis=-1)
    b = x.shape[-1]
    return x, filtered[:, b:].astype(jnp.complex64)


SEG_MULT = 8  # dispatch-path FFT segment length, in blocks (power of two)


def apply_many(state: jax.Array, x_cat: jax.Array, mask: jax.Array,
               block: int, seg_mult: int = SEG_MULT):
    """K overlap-save rounds in ONE batched FFT — equal to K sequential
    apply() calls on consecutive blocks (to FFT rounding, ~1e-7).

    x_cat: [C, K*block] (K consecutive blocks concatenated in time),
    state: [C, block] previous block.  Returns (new_state, y [C, K*block]).
    The batched form exists so a multi-block dispatch pays the op-launch
    overhead once instead of K times.

    seg_mult > 1 additionally LENGTHENS the overlap-save segments: FFT size
    L = seg_mult*B, each segment emitting T = L - B samples, so the
    dispatch does ~K/(seg_mult-1) FFTs of L instead of K FFTs of 2B —
    fewer total points (N·logN wins) and ~1.6x less FFT traffic at the
    default 8.  The filter is identical: the 2B-bin runtime mask converts
    to the L-bin mask by ifft -> (B+1 taps) -> fft, two tiny transforms per
    dispatch.  The sequential-equivalence property is unchanged — segment
    s's outputs are the SAME linear convolution samples, just grouped
    differently (the 50%-overlap pairing is the seg_mult=2 special case)."""
    c, l = x_cat.shape
    k = l // block
    ext = jnp.concatenate([state, x_cat], axis=-1)     # [C, (K+1)*B]
    b = block
    if seg_mult > 2 and k >= seg_mult:
        t = (seg_mult - 1) * b                         # outputs per segment
        n_seg = -(-l // t)
        # buffer must reach (n_seg+1)*t so BOTH reshapes below are whole-
        # chunk (windows only read up to n_seg*t + b; the zero padding
        # beyond feeds discarded outputs)
        need = (n_seg + 1) * t
        if need > ext.shape[-1]:
            ext_p = jnp.pad(ext, ((0, 0), (0, need - ext.shape[-1])))
        else:
            ext_p = ext
        # windows[s] = ext[:, s*T : s*T + T + B]: two contiguous reshapes
        # + one concat (same trick as the 50% pairing, generalized)
        lo = ext_p[:, :n_seg * t].reshape(c, n_seg, t)
        hi = ext_p[:, t:t + n_seg * t].reshape(c, n_seg, t)[:, :, :b]
        wins = jnp.concatenate([lo, hi], axis=-1)      # [C, S, T+B]
        taps = jnp.fft.ifft(mask)[:b + 1]              # exact by construction
        mask_l = jnp.fft.fft(taps, n=t + b)
        spec = jnp.fft.fft(wins, axis=-1)
        filtered = jnp.fft.ifft(spec * mask_l[None, None, :], axis=-1)
        y = filtered[:, :, b:].reshape(c, n_seg * t)[:, :l]
        return ext[:, -b:], y.astype(jnp.complex64)
    # seg_mult == 2: the classic 50%-overlap pairing (window k = blocks
    # (k, k+1)) — not a K-long unrolled slice+stack, which costs O(K) ops,
    # a [K, C, ·] relayout on each side of the FFT, and made the dispatch
    # cost scale with K (measured: K=128 ran SLOWER per block than K=64
    # through the old form)
    lo = ext[:, :l].reshape(c, k, block)               # blocks 0..K-1
    hi = ext[:, block:].reshape(c, k, block)           # blocks 1..K
    wins = jnp.concatenate([lo, hi], axis=-1)          # [C, K, 2B]
    spec = jnp.fft.fft(wins, axis=-1)
    filtered = jnp.fft.ifft(spec * mask[None, None, :], axis=-1)
    y = filtered[:, :, block:].reshape(c, l)
    return ext[:, -block:], y.astype(jnp.complex64)
