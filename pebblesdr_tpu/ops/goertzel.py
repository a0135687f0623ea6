"""Goertzel tone detection: single-bin DFT power + OOK (on/off keying) detector.

Capability parity with Goertzel/GoertzelOOK (pebblelib/goertzel.{h,cpp}):
  * classic power and complex non-integer-k single-bin DFT (goertzel.h:34-54),
  * GoertzelOOK: main/low/high compare bins, threshold modes, debounce with
    attack/decay counters (goertzel.h:84-104),
  * DTMF / CTCSS tone tables (goertzel.h:194-277).

Design: the reference runs a per-sample 2nd-order recurrence.  A
Goertzel bin is just a dot product with exp(-j*2*pi*k*n/N), so we reshape the
stream into [bins, N] frames and evaluate ALL detection bins for ALL frames as
one matmul — mathematically identical (including non-integer k), with no
sequential state at all.  Only the OOK debounce (a handful of per-frame
counter updates) remains a scan, over frames rather than samples.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core.block import pytree_dataclass, static_field
from pebblesdr_tpu.core.precision import DOT_PRECISION

# DTMF: (low Hz, high Hz) per key (goertzel.h:194-230 capability)
DTMF_FREQS = {
    "1": (697, 1209), "2": (697, 1336), "3": (697, 1477), "A": (697, 1633),
    "4": (770, 1209), "5": (770, 1336), "6": (770, 1477), "B": (770, 1633),
    "7": (852, 1209), "8": (852, 1336), "9": (852, 1477), "C": (852, 1633),
    "*": (941, 1209), "0": (941, 1336), "#": (941, 1477), "D": (941, 1633),
}

# CTCSS sub-audible squelch tones in Hz (goertzel.h:232-277 capability)
CTCSS_TONES = [
    67.0, 69.3, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5, 94.8, 97.4,
    100.0, 103.5, 107.2, 110.9, 114.8, 118.8, 123.0, 127.3, 131.8, 136.5,
    141.3, 146.2, 151.4, 156.7, 162.2, 167.9, 173.8, 179.9, 186.2, 192.8,
    203.5, 210.7, 218.1, 225.7, 233.6, 241.8, 250.3,
]


def dft_vectors(freqs_hz, sample_rate: float, n: int) -> np.ndarray:
    """[num_bins, n] complex64 DFT basis rows (non-integer k supported)."""
    freqs = np.atleast_1d(np.asarray(freqs_hz, np.float64))
    t = np.arange(n, dtype=np.float64)
    return np.exp(-2j * np.pi * freqs[:, None] * t[None, :] / sample_rate).astype(
        np.complex64)


def goertzel_power(x: jax.Array, basis: jax.Array):
    """x: [C, F, N] complex frames, basis [B, N] -> power [C, F, B].

    Normalized so a unit-amplitude tone exactly on bin gives power 1.0.
    """
    n = x.shape[-1]
    resp = jnp.einsum("cfn,bn->cfb", x, basis, precision=DOT_PRECISION) / n
    return jnp.abs(resp) ** 2


def frame_stream(x: jax.Array, frame: int) -> jax.Array:
    """[C, N] -> [C, N//frame, frame] (N must divide; chain planner ensures)."""
    c, n = x.shape
    return x.reshape(c, n // frame, frame)


# ------------------------------------------------------- N estimation
# (goertzel.h:103-104, goertzel.cpp:438-455 capability)

def est_n_for_shortest_bit(ms_shortest_bit: float, sample_rate: float) -> int:
    """Largest usable integration length: N must be shorter than the
    shortest keying element or bit transitions smear (e.g. 120 wpm morse:
    10 ms dot at 8 ksps -> N <= 80)."""
    return max(1, int(ms_shortest_bit * 1e-3 * sample_rate))


def est_n_for_bin_bandwidth(bandwidth_hz: float, sample_rate: float) -> int:
    """Smallest N whose bin is narrow enough: bin width = fs/N, so
    N >= fs/bandwidth (e.g. 100 Hz bin at 8 ksps -> N >= 80)."""
    return max(1, int(round(sample_rate / bandwidth_hz)))


def choose_n(sample_rate: float, ms_shortest_bit: float | None = None,
             bandwidth_hz: float | None = None) -> int:
    """Integration length from timing + selectivity constraints: as narrow a
    bin as the bandwidth asks for, capped so no keying element is smeared.
    With only one constraint given, that one decides."""
    n_max = (est_n_for_shortest_bit(ms_shortest_bit, sample_rate)
             if ms_shortest_bit is not None else None)
    n_min = (est_n_for_bin_bandwidth(bandwidth_hz, sample_rate)
             if bandwidth_hz is not None else None)
    if n_min is None and n_max is None:
        raise ValueError("need ms_shortest_bit and/or bandwidth_hz")
    if n_min is None:
        return n_max
    if n_max is None:
        return n_min
    return min(n_min, n_max)


def compare_bin_freqs(tone_hz: float, n: int, sample_rate: float,
                      delta_frac: float = 0.75):
    """(low, high) compare-bin frequencies at tone ± delta_frac·binwidth
    (the reference places them at ±0.75 bandwidth, goertzel.cpp:503-506)."""
    bw = sample_rate / n
    return tone_hz - delta_frac * bw, tone_hz + delta_frac * bw


# --------------------------------------------------------- OOK detector

THRESHOLD_MODES = ("compare", "peak", "average", "min_max", "manual", "noise")


@pytree_dataclass
class OOKConfig:
    """Threshold scheme for the on/off decision (GoertzelOOK's
    TH_COMPARE/AVERAGE/PEAK/MIN_MAX/MANUAL/NOISE family, goertzel.h:84;
    the reference fully implements COMPARE and PEAK and stubs the rest —
    all six are real here).

      compare — KA7OEI differential: main power > compare_ratio x the mean
                of the two off-tone bins (ref default ratio 4);
      peak    — adaptive AGC-style: EWMA peak + floor envelopes, mark above
                floor + 0.67 delta, space below floor + 0.33 delta,
                hysteresis in between (the reference's best-tested mode);
      average — main power > avg_ratio x running mean power;
      min_max — single threshold at floor + 0.6 delta, gated on the
                envelopes being far enough apart to indicate a signal;
      manual  — fixed absolute power threshold;
      noise   — squelch vs a noise estimate tracked during space frames:
                mark when power > noise_snr x noise floor.

    attack_frames/decay_frames: asymmetric debounce — consecutive frames
    required to recognize tone-on vs tone-off (goertzel.cpp:531-556).
    """
    mode: str = static_field()
    compare_ratio: float = static_field()
    avg_ratio: float = static_field()
    manual_threshold: float = static_field()
    noise_snr: float = static_field()
    attack_frames: int = static_field()
    decay_frames: int = static_field()
    attack_alpha: float = static_field()   # envelope EWMA, toward the signal
    decay_alpha: float = static_field()    # envelope EWMA, away from it
    avg_alpha: float = static_field()      # running-mean EWMA (average mode)
    min_max_snr: float = static_field()    # min peak/floor ratio for min_max

    @staticmethod
    def make(mode: str = "peak", compare_ratio: float = 4.0,
             avg_ratio: float = 1.5, manual_threshold: float = 1e-3,
             noise_snr: float = 4.0, attack_frames: int = 2,
             decay_frames: int = 2, attack_alpha: float = 0.4,
             decay_alpha: float = 0.02, avg_alpha: float = 0.01,
             min_max_snr: float = 4.0) -> "OOKConfig":
        if mode not in THRESHOLD_MODES:
            raise ValueError(f"mode {mode!r} not in {THRESHOLD_MODES}")
        return OOKConfig(mode=mode, compare_ratio=compare_ratio,
                         avg_ratio=avg_ratio,
                         manual_threshold=manual_threshold,
                         noise_snr=noise_snr, attack_frames=attack_frames,
                         decay_frames=decay_frames,
                         attack_alpha=attack_alpha, decay_alpha=decay_alpha,
                         avg_alpha=avg_alpha, min_max_snr=min_max_snr)


@pytree_dataclass
class OOKState:
    peak: jax.Array     # [C] EWMA peak power envelope
    floor: jax.Array    # [C] EWMA floor/noise power envelope
    avg: jax.Array      # [C] running mean power
    state: jax.Array    # [C] bool current mark/space decision
    attack: jax.Array   # [C] int32 consecutive on-frames while off
    decay: jax.Array    # [C] int32 consecutive off-frames while on


def ook_init(channels: int) -> OOKState:
    return OOKState(
        peak=jnp.full((channels,), 1e-6, jnp.float32),
        floor=jnp.full((channels,), 1e-6, jnp.float32),
        avg=jnp.full((channels,), 1e-6, jnp.float32),
        state=jnp.zeros((channels,), bool),
        attack=jnp.zeros((channels,), jnp.int32),
        decay=jnp.zeros((channels,), jnp.int32),
    )


def _raw_decision(cfg: OOKConfig, pm, pl, ph, peak, floor, avg, last):
    """The per-frame threshold decision for one mode (pure, no debounce)."""
    if cfg.mode == "compare":
        return pm > cfg.compare_ratio * jnp.maximum((pl + ph) * 0.5, 1e-18)
    if cfg.mode == "peak":
        delta = peak - floor
        up = floor + 0.67 * delta
        down = floor + 0.33 * delta
        return jnp.where(pm >= up, True, jnp.where(pm <= down, False, last))
    if cfg.mode == "average":
        return pm > cfg.avg_ratio * avg
    if cfg.mode == "min_max":
        valid = peak > cfg.min_max_snr * jnp.maximum(floor, 1e-18)
        return valid & (pm > floor + 0.6 * (peak - floor))
    if cfg.mode == "manual":
        return pm > cfg.manual_threshold
    # noise: squelch vs the noise estimate tracked during space
    return pm > cfg.noise_snr * jnp.maximum(floor, 1e-18)


# --------------------------------------------------------- CTCSS squelch
#
# Sub-audible tone squelch (the capability goertzel.h:232-277 ships tables
# for).  Neighboring CTCSS tones sit 2.3-4 Hz apart at the low end, so a
# one-block DFT (e.g. 21 ms audio block -> 47 Hz bins) cannot discriminate
# them.  Reformulation: per block we take the tone's single-bin DFT
# response, de-rotate it by the block-start carrier phase (tracked in state,
# advanced closed-form by 2*pi*f*blk/fs per block) and EWMA the COMPLEX
# response — coherent integration with an exponential window.  The effective
# noise bandwidth is (1-a)/(pi) * fs/blk ~ 1-2 Hz for a ~0.25 s time
# constant, enough to separate any two table neighbors, while the chain
# keeps its fixed per-block cost (three dot products).  Decision: the
# configured tone's integrated power must dominate both neighbor tones.

@pytree_dataclass
class CtcssConfig:
    tone_hz: float = static_field()
    alpha: float = static_field()          # per-block EWMA
    nb_ratio: float = static_field()       # tone power vs max neighbor
    min_power: float = static_field()      # absolute floor (squelch silence)
    basis_re: np.ndarray = static_field()  # [3, blk] block-local DFT rows
    basis_im: np.ndarray = static_field()
    dphi: np.ndarray = static_field()      # [3] phase advance per block (rad)

    @staticmethod
    def make(tone_hz: float, sample_rate: float, blk: int,
             tau_s: float = 0.25, nb_ratio: float = 4.0,
             min_power: float = 1e-5) -> "CtcssConfig":
        tones = sorted(CTCSS_TONES)
        if tone_hz not in tones:
            raise ValueError(f"{tone_hz} Hz is not a CTCSS table tone")
        i = tones.index(tone_hz)
        lo = tones[i - 1] if i > 0 else tone_hz - 2.3
        hi = tones[i + 1] if i + 1 < len(tones) else tone_hz + 4.0
        freqs = [tone_hz, lo, hi]
        basis = dft_vectors(freqs, sample_rate, blk)
        alpha = float(np.exp(-(blk / sample_rate) / tau_s))
        dphi = (2.0 * np.pi * np.asarray(freqs, np.float64) * blk
                / sample_rate) % (2.0 * np.pi)
        return CtcssConfig(tone_hz=tone_hz, alpha=alpha, nb_ratio=nb_ratio,
                           min_power=min_power,
                           basis_re=basis.real.astype(np.float32),
                           basis_im=basis.imag.astype(np.float32),
                           dphi=dphi.astype(np.float32))


@pytree_dataclass
class CtcssState:
    iq: jax.Array     # [C, 3, 2] EWMA of de-rotated (re, im) responses
    phase: jax.Array  # [3] block-start carrier phase (rad)


def ctcss_init(channels: int) -> CtcssState:
    return CtcssState(iq=jnp.zeros((channels, 3, 2), jnp.float32),
                      phase=jnp.zeros((3,), jnp.float32))


def _ctcss_resp(cfg: CtcssConfig, audio: jax.Array):
    """audio [..., blk] real -> de-rotatable block responses [..., 3, 2]."""
    blk = audio.shape[-1]
    with jax.ensure_compile_time_eval():
        bre = jnp.asarray(cfg.basis_re)
        bim = jnp.asarray(cfg.basis_im)
    re = jnp.einsum("...n,bn->...b", audio, bre,
                    precision=DOT_PRECISION) / blk
    im = jnp.einsum("...n,bn->...b", audio, bim,
                    precision=DOT_PRECISION) / blk
    return jnp.stack([re, im], axis=-1)


def _ctcss_open(cfg: CtcssConfig, iq):
    p = jnp.sum(iq * iq, axis=-1)                      # [..., 3]
    p_tone, p_lo, p_hi = p[..., 0], p[..., 1], p[..., 2]
    return ((p_tone > cfg.nb_ratio * jnp.maximum(p_lo, p_hi))
            & (p_tone > cfg.min_power))


def _rot(iq, cos, sin):
    """Rotate (re, im) pairs by -phase given cos/sin of phase."""
    re = iq[..., 0] * cos + iq[..., 1] * sin
    im = iq[..., 1] * cos - iq[..., 0] * sin
    return jnp.stack([re, im], axis=-1)


def ctcss_update(cfg: CtcssConfig, state: CtcssState, audio: jax.Array):
    """One block: audio [C, blk] real -> (state', open [C] bool)."""
    resp = _ctcss_resp(cfg, audio)                     # [C, 3, 2]
    cos = jnp.cos(state.phase)[None, :, None]
    sin = jnp.sin(state.phase)[None, :, None]
    resp = _rot(resp, cos[..., 0], sin[..., 0])
    a = cfg.alpha
    iq = a * state.iq + (1.0 - a) * resp
    with jax.ensure_compile_time_eval():
        dphi = jnp.asarray(cfg.dphi)
    phase = jnp.mod(state.phase + dphi, 2.0 * np.pi)
    return CtcssState(iq=iq, phase=phase), _ctcss_open(cfg, iq)


def ctcss_update_many(cfg: CtcssConfig, state: CtcssState, audio: jax.Array):
    """K blocks, one straight-line graph: audio [K, C, blk] ->
    (state', open [K, C] bool).  The cross-block EWMA is the closed-form
    lower-triangular matmul (no scan); block k's response is de-rotated by
    phase + k*dphi."""
    k, c, blk = audio.shape
    resp = _ctcss_resp(cfg, audio)                     # [K, C, 3, 2]
    with jax.ensure_compile_time_eval():
        dphi = jnp.asarray(cfg.dphi)
        ks = jnp.arange(k, dtype=jnp.float32)
    ang = state.phase[None, :] + ks[:, None] * dphi[None, :]   # [K, 3]
    resp = _rot(resp, jnp.cos(ang)[:, None, :], jnp.sin(ang)[:, None, :])
    a = cfg.alpha
    kk = np.arange(k)
    lmat = np.where(kk[:, None] >= kk[None, :],
                    (1.0 - a) * float(a) ** np.maximum(
                        kk[:, None] - kk[None, :], 0), 0.0)
    with jax.ensure_compile_time_eval():
        lmat_d = jnp.asarray(lmat.astype(np.float32))
        seed_d = jnp.asarray((float(a) ** (kk + 1)).astype(np.float32))
    flat = resp.reshape(k, -1)
    iq = (jnp.matmul(lmat_d, flat, precision=DOT_PRECISION)
          .reshape(resp.shape) + seed_d[:, None, None, None] * state.iq[None])
    phase = jnp.mod(state.phase + k * dphi, 2.0 * np.pi)
    return (CtcssState(iq=iq[-1], phase=phase),
            _ctcss_open(cfg, iq))


def ook_detect(cfg: OOKConfig, state: OOKState, power_main: jax.Array,
               power_low: jax.Array, power_high: jax.Array):
    """OOK decision per frame (GoertzelOOK::processResult capability,
    goertzel.cpp:676-820) with the configured threshold mode and asymmetric
    attack/decay debounce.

    power_*: [C, F] main and low/high compare-bin powers.
    Returns (state', marks [C, F] bool).
    """

    def step(carry, pows):
        peak, floor, avg, st, att, dec = carry
        pm, pl, ph = pows
        # envelope tracking: fast toward the signal, slow away (the
        # reference's MovingAvgFilter attack/decay weights)
        peak2 = jnp.where(pm > peak,
                          peak + cfg.attack_alpha * (pm - peak),
                          peak + cfg.decay_alpha * (pm - peak))
        # the floor drifts up 10x slower than the peak drifts down: a long
        # mark must not swallow the noise floor (the reference's min-filter
        # decay is likewise far slower than its attack, goertzel.cpp:727-730)
        floor2 = jnp.where(pm < floor,
                           floor + cfg.attack_alpha * (pm - floor),
                           floor + 0.1 * cfg.decay_alpha * (pm - floor))
        if cfg.mode == "noise":
            # noise floor only learns while the tone is off
            floor2 = jnp.where(st, floor, floor2)
        avg2 = (1.0 - cfg.avg_alpha) * avg + cfg.avg_alpha * pm
        raw = _raw_decision(cfg, pm, pl, ph, peak2, floor2, avg2, st)
        # asymmetric debounce counters (goertzel.cpp:531-556)
        att2 = jnp.where(raw & ~st, att + 1, jnp.zeros_like(att))
        dec2 = jnp.where(~raw & st, dec + 1, jnp.zeros_like(dec))
        turn_on = att2 >= cfg.attack_frames
        turn_off = dec2 >= cfg.decay_frames
        st2 = jnp.where(turn_on, True, jnp.where(turn_off, False, st))
        att2 = jnp.where(turn_on, jnp.zeros_like(att2), att2)
        dec2 = jnp.where(turn_off, jnp.zeros_like(dec2), dec2)
        return (peak2, floor2, avg2, st2, att2, dec2), st2

    carry0 = (state.peak, state.floor, state.avg, state.state,
              state.attack, state.decay)
    seq = (jnp.moveaxis(power_main, 1, 0), jnp.moveaxis(power_low, 1, 0),
           jnp.moveaxis(power_high, 1, 0))
    (peak, floor, avg, st, att, dec), marks = jax.lax.scan(step, carry0, seq)
    return (OOKState(peak=peak, floor=floor, avg=avg, state=st,
                     attack=att, decay=dec),
            jnp.moveaxis(marks, 0, 1))
