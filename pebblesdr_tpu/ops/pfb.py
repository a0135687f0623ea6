"""Critically-sampled polyphase filterbank (PFB) channelizer.

SURVEY §7.6 names two ways to turn one wideband capture into N channels:
per-channel NCO mixers (what `parallel/channelizer.py` and the Receiver's
front end do — right for arbitrary tune frequencies) and the polyphase filterbank —
right for a UNIFORM channel grid, where it replaces M independent
mix+decimate chains with ONE prototype FIR + one M-point transform per
output frame.  The transform is a dense M×M DFT matmul for small M and a
batched FFT + fixed phase for large M, i.e. O(T + log M) per channel-sample
asymptotically, O(T + M) on the small-M matmul path.

Math (standard identity, verified bit-close in tests/test_pfb.py): with
sampling instants s_k = k·M + M − 1 (frame k ends after M fresh samples),

    y_m[k] = sum_n h[n] · x[s_k − n] · e^{+2πi·m·n/M}
           = e^{+2πi·m·(M−1)/M} · [ lowpass_h( x · e^{−2πi·m·t/M} ) ](s_k),

i.e. the input band centered at +m·fs/M (wrapped into [−fs/2, fs/2)),
downconverted to baseband and decimated by M, with a fixed per-channel
phase — computed for ALL M channels at once as polyphase branches + one
M-point DFT matrix dot per frame.

Device mapping: the branch filter is ONE einsum over a [K, T, M] strided
window stack (T taps × M branches per output frame), and the
M-point IFFT batches over frames.  Streaming state is the last T·M−M input
samples — the same carry-tail convention as every other stream op here.

The prototype is a Kaiser lowpass at cutoff fs/(2M) (one channel's Nyquist),
designed host-side in float64 like ops.fir.

Reference capability analog: none (the reference tunes one channel at a
time); this is the accelerator widening of `CDownConvert`
(pebblelib/downconvert.cpp:257-325) to a full uniform grid.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as sps

from pebblesdr_tpu.core.precision import DOT_PRECISION


@dataclasses.dataclass(frozen=True)
class PfbPlan:
    n_chan: int          # M: channels
    taps_per_branch: int  # T
    h: np.ndarray        # [T*M] float32 prototype (linear phase)
    fs_in: float
    fs_out: float        # fs_in / hop
    os: int = 1          # oversampling: frames advance by M/os samples

    @property
    def hop(self) -> int:
        return self.n_chan // self.os

    @property
    def state_len(self) -> int:
        return self.n_chan * self.taps_per_branch - self.hop


def plan(fs_in: float, n_chan: int, taps_per_branch: int = 12,
         beta: float = 9.0, os: int = 1) -> PfbPlan:
    """Design an M-channel plan.

    os=1 (critical sampling): the Kaiser prototype cuts at the channel
    Nyquist fs_in/(2M); taps_per_branch trades adjacent-channel rejection
    (12 taps ≈ 80 dB at beta=9) against state length.  Stations near
    channel EDGES lose sideband energy (alias-folded at decimation).

    os=2 (2x oversampled): frames advance by M/2 samples, so each channel
    runs at 2·fs/M and the alias-free passband doubles — the prototype's
    −6 dB point moves out to fs_in/M, keeping an edge station's full
    bandwidth recoverable (the tail Receiver's FastFIR removes the
    neighbor's energy).  The sharper normalized transition needs a longer
    prototype: taps_per_branch defaults up to 32.
    """
    m = int(n_chan)
    os = int(os)
    if os not in (1, 2):
        raise ValueError(f"os={os}: only 1 (critical) or 2 supported")
    if m % os:
        raise ValueError(f"n_chan {m} must divide by os {os}")
    t = int(taps_per_branch) if os == 1 else max(int(taps_per_branch), 32)
    n = m * t
    cutoff = (1.0 if os == 1 else 2.0) / m  # fraction of input Nyquist
    h = sps.firwin(n, cutoff, window=("kaiser", beta), scale=True)
    return PfbPlan(n_chan=m, taps_per_branch=t,
                   h=np.asarray(h, np.float32), fs_in=float(fs_in),
                   fs_out=float(fs_in) / (m // os), os=os)


def init_state(p: PfbPlan, channels_in: int = 1) -> jax.Array:
    """Carry: the last T·M−M input samples per input row."""
    return jnp.zeros((channels_in, p.state_len), jnp.complex64)


def channel_freqs(p: PfbPlan) -> np.ndarray:
    """Center frequency (Hz, in [−fs/2, fs/2)) of each output channel row."""
    m = p.n_chan
    k = np.arange(m)
    f = k * p.fs_in / m             # y_m sits at +m·fs/M …
    f[f >= p.fs_in / 2] -= p.fs_in  # … wrapping into the Nyquist interval
    return f


def apply(p: PfbPlan, state: jax.Array, x: jax.Array):
    """One block through the filterbank.

    x: [R, N] complex64 input rows (N % hop == 0).
    Returns (state', y [R, M, N/hop] complex64): row r's M uniform channels
    at fs_out, centered at ``channel_freqs(p)``.
    """
    r, n = x.shape
    m, t = p.n_chan, p.taps_per_branch
    hop = p.hop
    if n % hop:
        raise ValueError(f"block length {n} not divisible by hop {hop}")
    if p.os == 2 and (n // hop) % 2:
        # the per-frame twiddle below is (-1)^(m*(k+1)) with k local to the
        # call; whole frame PAIRS per call keep the global parity consistent
        # across streaming calls (and across time shards)
        raise ValueError(f"os=2 needs whole frame pairs per call: "
                         f"{n} samples = {n // hop} frames of hop {hop}")
    k_out = n // hop
    u = (m * t) // hop                                # hop-rows per window
    ext = jnp.concatenate([state, x], axis=1)         # [R, TM - hop + N]
    new_state = ext[:, -p.state_len:]

    # Frame k consumes ext[k·hop : k·hop + TM); within the window, position
    # w = t'M + p' carries prototype index n = TM − 1 − w (filter reversal),
    # so the tap table is the fully-reversed prototype reshaped [T, M].
    # Build the windows with ONE strided reshape (no per-sample gather):
    # ext2[a, q] = ext[a·hop + q], frames[k, u'] = ext2[k + u'] — the U
    # consecutive hop-rows concatenate to the TM contiguous window samples
    # regardless of hop, so the [T, M] reshape below is exact for os=2 too.
    ext2 = ext.reshape(r, (k_out + u - 1), hop)
    idx_k = jnp.arange(k_out)[:, None] + jnp.arange(u)[None, :]  # [K, U]
    frames = ext2[:, idx_k, :].reshape(r, k_out, t, m)
    hb = p.h.reshape(t, m)[::-1, ::-1].copy()         # hb[t', p'] = h[n]
    v = jnp.einsum("rktm,tm->rkm", frames, jnp.asarray(hb, jnp.float32),
                   precision=DOT_PRECISION)
    # y_m[k] = sum_{p'} v_{p'}[k] e^{+2πi·m·(M−1−p')/M}
    #        = e^{+2πi·m·(M−1)/M} · FFT_m(v[k]).
    # Small M: one [K, M] @ [M, M] DFT-matrix dot.  Large M: the dense
    # matrix is O(M²) per frame in time and memory, so switch to the batched
    # FFT + fixed per-channel phase — O(M log M) per frame.
    if m <= 128:
        pp = np.arange(m)
        dft = np.exp(2j * np.pi * np.outer(m - 1 - pp, pp) / m
                     ).astype(np.complex64)
        y = jnp.einsum("rkm,mc->rck", v, jnp.asarray(dft),
                       precision=DOT_PRECISION)               # [R, M, K]
    else:
        phase = np.exp(2j * np.pi * np.arange(m) * (m - 1) / m
                       ).astype(np.complex64)
        yf = jnp.fft.fft(v.astype(jnp.complex64), axis=-1)  # [R, K, M]
        y = jnp.moveaxis(yf * jnp.asarray(phase)[None, None, :], 1, 2)
    if p.os == 2:
        # oversampled frames end at s_k = (k+1)·hop − 1 (the streaming grid:
        # the k-th output consumes hop fresh samples, so block outputs end
        # exactly at the block edge), giving the channel-m output a
        # per-frame phase e^{+2πi·m·(k+1)·hop/M} = (−1)^{m·(k+1)} on top of
        # the critical path's constant; undo it so every channel is a
        # frequency-correct baseband stream at 2·fs/M
        mm = np.arange(m)[:, None]
        kk = np.arange(k_out)[None, :]
        tw = np.where((mm * (kk + 1)) % 2 == 0, 1.0, -1.0).astype(np.float32)
        y = y * jnp.asarray(tw)[None, :, :]
    return new_state, y
