"""AGC: log-domain automatic gain control with peak window, attack/decay, hang.

Capability parity with the CuteSDR AGC (application/agc.{h,cpp}): magnitude in
log domain, sliding-window peak detector (WINDOW_TIMECONST=18 ms), separate
attack (2/5 ms rise/fall) and decay (mode-dependent 100-2000 ms, rise/fall
ratio 0.3) smoothers, optional hang timer, knee/slope gain law, and a signal
delay line (DELAY_TIMECONST=15 ms) aligning gain with signal; modes
OFF/FAST/MED/SLOW/LONG (agc.cpp:52-200, constants agc.h:31-59).

Design, hybrid parallel/sequential:
  * magnitude->log and the sliding-window peak are parallel (reduce_window max);
  * the attack/decay smoothers switch coefficients on compare — a nonlinear
    recurrence — so they run as ONE lax.scan over the block with tiny scalar
    state per channel.  At demod rate (<=48 ksps) this scan is short; a
    `stride` option runs the smoother on a decimated envelope and linearly
    interpolates gain between points (documented deviation; stride=1 is
    sample-exact).
  * the delay line is a static roll through a carried buffer.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from pebblesdr_tpu.core.block import pytree_dataclass, static_field
from pebblesdr_tpu.ops.iir import first_order_apply

# agc.h constants
DELAY_TIMECONST = 0.015
WINDOW_TIMECONST = 0.018
ATTACK_RISE_TIMECONST = 0.002
ATTACK_FALL_TIMECONST = 0.005
DECAY_RISEFALL_RATIO = 0.3
RELEASE_TIMECONST = 0.05
AGC_OUTSCALE = 0.7
MAX_AMPLITUDE = 1.0
MIN_CONSTANT = 1e-8  # log floor ~ -160 dB

MODES = {  # mode -> (decay_ms, use_hang)  (agc.cpp mode table capability)
    "off": (0.0, False),
    "fast": (100.0, False),
    "med": (250.0, False),
    "slow": (500.0, False),
    "long": (2000.0, True),
}


@pytree_dataclass
class AGCConfig:
    sample_rate: float = static_field()
    mode: str = static_field()
    threshold_db: float = static_field(default=-20.0)  # knee
    slope_factor: float = static_field(default=0.0)    # output slope above knee, 0..1
    stride: int = static_field(default=1)
    window: int = static_field(default=0)              # peak window samples
    delay: int = static_field(default=0)               # delay-line samples
    algorithm: str = static_field(default="parallel")  # 'parallel' | 'scan'

    @staticmethod
    def make(sample_rate: float, mode: str = "med", threshold_db: float = -20.0,
             slope_factor: float = 0.0, stride: int = 1,
             algorithm: str = "parallel") -> "AGCConfig":
        return AGCConfig(
            sample_rate=sample_rate, mode=mode, threshold_db=threshold_db,
            slope_factor=slope_factor, stride=stride, algorithm=algorithm,
            window=max(1, int(WINDOW_TIMECONST * sample_rate)),
            delay=max(1, int(DELAY_TIMECONST * sample_rate)),
        )


@pytree_dataclass
class AGCState:
    attack_avg: jax.Array   # [C] log-domain attack smoother (fast/rise pole)
    decay_avg: jax.Array    # [C] log-domain decay smoother
    hang_count: jax.Array   # [C] int32 hang timer (scan path)
    window_tail: jax.Array  # [C, window-1] previous log-magnitudes
    delay_line: jax.Array   # [C, delay] delayed complex signal
    attack_fall_avg: jax.Array = None  # [C] slow/fall pole (parallel path)
    hang_tail: jax.Array = None        # [C, hang-1] coarse peak history
    #                                    (parallel hang window; 'long' mode)


def hang_window(cfg: AGCConfig) -> int:
    """Parallel-path hang window length on the coarse (stride) grid."""
    decay_ms, use_hang = MODES[cfg.mode]
    if not use_hang or cfg.algorithm != "parallel":
        return 0
    return max(1, int((decay_ms / 1000.0) * cfg.sample_rate) // cfg.stride)


def agc_init(cfg: AGCConfig, channels: int) -> AGCState:
    floor = math.log10(MIN_CONSTANT)
    if cfg.algorithm == "parallel" and cfg.stride > 1:
        # the strided parallel path keeps its peak-window tail on the coarse
        # (one-max-per-stride) grid
        w = max(1, cfg.window // cfg.stride)
    else:
        w = cfg.window
    h = hang_window(cfg)
    return AGCState(
        attack_avg=jnp.full((channels,), floor, jnp.float32),
        decay_avg=jnp.full((channels,), floor, jnp.float32),
        hang_count=jnp.zeros((channels,), jnp.int32),
        window_tail=jnp.full((channels, max(w - 1, 0)), floor, jnp.float32),
        delay_line=jnp.zeros((channels, cfg.delay), jnp.complex64),
        attack_fall_avg=jnp.full((channels,), floor, jnp.float32),
        hang_tail=(jnp.full((channels, h - 1), floor, jnp.float32)
                   if h > 1 else None),
    )


def _coef(timeconst_s: float, rate: float) -> float:
    return 1.0 - math.exp(-1.0 / (max(rate * timeconst_s, 1.0)))


def _agc_apply_parallel(cfg: AGCConfig, state: AGCState, x: jax.Array):
    c, n = x.shape
    rate = cfg.sample_rate
    decay_ms, use_hang = MODES[cfg.mode]

    # stride>1: collapse the envelope to one max per `stride` samples FIRST,
    # then run every scan/window op on the N/stride coarse envelope (the gain
    # law only moves on ms timescales, so a 0.25 ms grid loses nothing; the
    # documented stride deviation).  All state arrays stay on the coarse grid.
    s = cfg.stride
    if s > 1 and n % s:
        raise ValueError(f"AGC stride {s} must divide block length {n}")
    # max commutes with the monotone log10, so decimate BEFORE the
    # transcendental: log10 runs on N/s elements, not N (bit-identical)
    mag = jnp.abs(x)
    if s > 1:
        mag = jnp.max(mag.reshape(c, n // s, s), axis=-1)
    logmag = jnp.log10(mag + MIN_CONSTANT)
    rate_s = rate / s
    window = max(1, cfg.window // s)
    ext = jnp.concatenate([state.window_tail, logmag], axis=-1)
    peak = _windowed_max(ext, window) if window > 1 else ext
    new_window_tail = (ext[:, -(window - 1):] if window > 1
                       else ext[:, :0])

    # hang ('long' mode): hold each peak for hang_samples before releasing.
    # A hang timer IS a trailing windowed max of width H — the envelope may
    # not fall below any peak seen in the last H samples — composed with the
    # exponential release below (which then starts from the END of the hold).
    # Same van Herk machinery as the 18 ms peak window, own carried tail.
    # Documented deviation vs the scan/reference recurrence: the held
    # envelope reaches each peak INSTANTLY, where the reference's decay
    # averager rises at 0.3*decay (600 ms) and only hang-holds the level it
    # actually reached (agc.cpp:159-170) — on short bursts the reference
    # therefore holds a lower level.  On the hang-defining fixture (steady
    # carrier, brief dropout) the two agree; test_parallel_hang_matches_scan.
    h = hang_window(cfg)
    if h > 1:
        ext_h = jnp.concatenate([state.hang_tail, peak], axis=-1)
        held = _windowed_max(ext_h, h)
        new_hang_tail = ext_h[:, -(h - 1):]
    else:
        held = peak
        new_hang_tail = state.hang_tail

    # exponential release: log10-amplitude decays at log10(e)/tau per second.
    # hang mode releases FAST (RELEASE_TIMECONST) once the hold expires — the
    # hang window is the slowness (agc.cpp:296-299: decayFallAlpha uses
    # RELEASE_TIMECONST when hang is on, the decay time otherwise)
    release_s = RELEASE_TIMECONST if use_hang else decay_ms / 1000.0
    d = 0.43429448 / max(release_s, 1e-3) / rate_s
    dec_last, env = _decaying_max(state.decay_avg, held, d)
    # attack smoothing with the CuteSDR rise/fall asymmetry (agc.cpp:159-170
    # attack smoother): the switched one-pole (rise 2 ms above, fall 5 ms
    # below) is not associative; max(fast_pole, slow_pole) is a documented
    # APPROXIMATION — exact on monotone envelope segments (rising: the 2 ms
    # pole is higher; falling: the 5 ms pole lags above), but after a dip
    # the recovering level transiently lags the switched form (measured
    # delta in the bench quality row agc_hang_par_vs_scan_db).  Two linear
    # recurrences (associative scans) + elementwise max.
    rise_coef = _coef(ATTACK_RISE_TIMECONST, rate_s)
    fall_coef = _coef(ATTACK_FALL_TIMECONST, rate_s)
    att_last, lvl_rise = first_order_apply(state.attack_avg, env,
                                           1.0 - rise_coef, rise_coef)
    attf_last, lvl_fall = first_order_apply(state.attack_fall_avg, env,
                                            1.0 - fall_coef, fall_coef)
    level = jnp.maximum(lvl_rise, lvl_fall)

    knee = cfg.threshold_db / 20.0
    log_gain = jnp.where(level > knee,
                         cfg.slope_factor * (level - knee) - level, -knee)
    gain = jnp.power(10.0, log_gain) * AGC_OUTSCALE
    if s > 1:
        # piecewise-linear gain interpolation back to the sample grid (avoids
        # staircase zipper): g[i*s + j] = lerp(g[i-1], g[i], (j+1)/s), i.e.
        # each coarse gain is reached at the END of its stride window.
        lvl0 = jnp.maximum(state.attack_avg, state.attack_fall_avg)
        lg0 = jnp.where(lvl0 > knee,
                        cfg.slope_factor * (lvl0 - knee) - lvl0, -knee)
        g0 = jnp.power(10.0, lg0) * AGC_OUTSCALE  # gain at end of prev block
        g_prev = jnp.concatenate([g0[:, None], gain[:, :-1]], axis=-1)
        w_up = (jnp.arange(1, s + 1, dtype=jnp.float32) / s)[None, None, :]
        gain = (g_prev[:, :, None] * (1.0 - w_up)
                + gain[:, :, None] * w_up).reshape(c, n)

    full = jnp.concatenate([state.delay_line, x], axis=-1)
    delayed = full[:, :n]
    new_delay = full[:, n:]
    y = (delayed * gain).astype(jnp.complex64)
    new_state = AGCState(attack_avg=att_last, decay_avg=dec_last,
                         hang_count=state.hang_count,
                         window_tail=new_window_tail, delay_line=new_delay,
                         attack_fall_avg=attf_last, hang_tail=new_hang_tail)
    return new_state, y


def _windowed_max(ext: jax.Array, w: int) -> jax.Array:
    """Trailing sliding-window max via van Herk/Gil-Werman: two cummax passes
    instead of a width-w reduce_window (which XLA compiles impractically
    slowly for w ~ 10^3).  ext: [C, N + w - 1] -> [C, N] where
    out[i] = max(ext[i:i+w])."""
    c, l = ext.shape
    n = l - w + 1
    nb = -(-l // w)
    pad = nb * w - l
    padded = jnp.pad(ext, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    blocks = padded.reshape(c, nb, w)
    pre = jax.lax.cummax(blocks, axis=2).reshape(c, nb * w)
    suf = jax.lax.cummax(blocks[:, :, ::-1], axis=2)[:, :, ::-1].reshape(c, nb * w)
    return jnp.maximum(suf[:, :n], pre[:, w - 1:w - 1 + n])


def _decaying_max(carry: jax.Array, p: jax.Array, d: float):
    """Exponential-release peak envelope, e[n] = max(e[n-1] - d, p[n]), as a
    SINGLE cummax: tilt by +d*n, running max, untilt —
        e[n] = max_{k<=n}(p[k] - d*(n-k)) = cummax(p + d*k)[n] - d*n.
    (d*N per block is ~0.03 log10 units, so the tilt costs no precision.)
    Returns (e_last [C], e [C, N]).
    """
    c, n = p.shape
    tilt = d * jnp.arange(n, dtype=p.dtype)[None, :]
    pp = p.at[:, 0].set(jnp.maximum(p[:, 0], carry - d))
    e = jax.lax.cummax(pp + tilt, axis=1) - tilt
    return e[:, -1], e


def agc_apply(cfg: AGCConfig, state: AGCState, x: jax.Array):
    """x: [C, N] complex64 -> (state', y [C, N]).  mode='off' is identity.

    algorithm='parallel' (default): windowed max -> decaying-max release ->
    attack EWMA, all associative scans / reduce_windows — zero sequential
    steps.  algorithm='scan' is the sample-exact
    CuteSDR attack/decay/hang recurrence via lax.scan (parity reference).
    """
    if cfg.mode == "off":
        return state, x
    if cfg.algorithm == "parallel":
        return _agc_apply_parallel(cfg, state, x)

    c, n = x.shape
    rate = cfg.sample_rate
    decay_ms, use_hang = MODES[cfg.mode]

    # --- parallel part: log magnitude + sliding-window peak ------------------
    logmag = jnp.log10(jnp.abs(x) + MIN_CONSTANT)  # [C, N]
    ext = jnp.concatenate([state.window_tail, logmag], axis=-1)
    peak = _windowed_max(ext, cfg.window)  # [C, N] peak over trailing window
    new_window_tail = ext[:, -(cfg.window - 1):]

    # --- sequential part: attack/decay smoothing -----------------------------
    attack_rise = _coef(ATTACK_RISE_TIMECONST, rate / cfg.stride)
    attack_fall = _coef(ATTACK_FALL_TIMECONST, rate / cfg.stride)
    decay_rise = _coef((decay_ms / 1000.0) * DECAY_RISEFALL_RATIO, rate / cfg.stride)
    # hang mode: fast release (RELEASE_TIMECONST) after the hold expires
    # (agc.cpp:296-299); exponential mode: release at the decay time
    decay_fall = _coef(RELEASE_TIMECONST if use_hang else decay_ms / 1000.0,
                       rate / cfg.stride)
    hang_samples = int((decay_ms / 1000.0) * rate / cfg.stride)

    env = peak[:, :: cfg.stride] if cfg.stride > 1 else peak  # [C, M]

    def step(carry, p):  # p: [C]
        att, dec, hang = carry
        att2 = jnp.where(p > att, att + attack_rise * (p - att),
                         att + attack_fall * (p - att))
        rising = p > dec
        if use_hang:
            hang2 = jnp.where(rising, 0, hang + 1)
            decaying = hang2 > hang_samples
            dec2 = jnp.where(rising, dec + decay_rise * (p - dec),
                             jnp.where(decaying, dec + decay_fall * (p - dec), dec))
        else:
            hang2 = hang
            dec2 = jnp.where(rising, dec + decay_rise * (p - dec),
                             dec + decay_fall * (p - dec))
        level = jnp.maximum(att2, dec2)
        return (att2, dec2, hang2), level

    carry0 = (state.attack_avg, state.decay_avg, state.hang_count)
    (att, dec, hang), levels = jax.lax.scan(step, carry0, jnp.moveaxis(env, 1, 0))
    levels = jnp.moveaxis(levels, 0, 1)  # [C, M] log-domain envelope

    if cfg.stride > 1:
        # piecewise-linear upsample of the envelope back to N
        levels = jax.image.resize(levels, (c, n), method="linear")

    # --- gain law: knee/slope (agc.cpp:84-200 capability) --------------------
    # below the knee: fixed max gain -knee (weak signals stay proportional);
    # above the knee: output held at full scale, rising with the small
    # slope_factor fraction (CuteSDR slope control).
    knee = cfg.threshold_db / 20.0  # log10-amplitude units
    env = levels
    log_gain = jnp.where(env > knee,
                         cfg.slope_factor * (env - knee) - env, -knee)
    gain = jnp.power(10.0, log_gain) * AGC_OUTSCALE

    # --- delay line: apply gain to the delayed signal ------------------------
    full = jnp.concatenate([state.delay_line, x], axis=-1)
    delayed = full[:, :n]
    new_delay = full[:, n:]
    y = (delayed * gain).astype(jnp.complex64)

    new_state = AGCState(attack_avg=att, decay_avg=dec, hang_count=hang,
                         window_tail=new_window_tail, delay_line=new_delay,
                         attack_fall_avg=state.attack_fall_avg,
                         hang_tail=state.hang_tail)
    return new_state, y
