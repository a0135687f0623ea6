"""Wideband broadcast FM: mono + pilot-PLL stereo demux (+ RDS baseband tap).

Capability parity with Demod_WFM (application/demod/demod_wfm.cpp):
  * conj-product atan2 discriminator (processDataMono :207-232),
  * stereo: 19 kHz pilot IIR bandpass (Q=500) + pilot PLL (BW 10 Hz), L-R
    demux via sin(2*pilotPhase) (:154-196, :275-284, :370+),
  * 15 kHz audio LP + 75/50 us de-emphasis + 19 kHz pilot notch (:361-363),
  * RDS tap: the composite is mixed by -57 kHz and decimated for the RDS
    bit/block decoder (:297; implemented in demod/rds.py).

Design: the discriminator is one shifted conj multiply + atan2 over
the whole [C, N] block; pilot recovery is the shared PLL scan; the audio LP
FIRs decimate (factor `audio_decim`) inside the conv so the expensive
fractional resampler runs at a few-x audio rate rather than the 256 kHz
composite rate (the reference resamples at full demod rate and flags it as
the dominant cost, receiver.cpp:998).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core.block import pytree_dataclass, static_field
from pebblesdr_tpu.core.precision import DOT_PRECISION
from pebblesdr_tpu.ops import fir, iir, mixer, pll

PILOT_HZ = 19000.0


@pytree_dataclass
class WFMConfig:
    sample_rate: float = static_field()          # composite rate (~256 kHz)
    stereo: bool = static_field(default=True)
    deemphasis_us: float = static_field(default=75.0)
    audio_decim: int = static_field(default=4)
    max_deviation: float = static_field(default=75000.0)
    pilot_chunk: int = static_field(default=256)  # blockwise pilot PLL chunk;
    #                                               0 = per-sample scan
    audio_taps: np.ndarray = static_field(default=None)
    pilot_bp: iir.BiquadCoef = static_field(default=None)
    pilot_notch: iir.BiquadCoef = static_field(default=None)
    pilot_pll: pll.PLLConfig = static_field(default=None)
    rds_tap: bool = static_field(default=False)
    # pilot recovery algorithm: "open" (default) = scan-free windowed-DFT
    # chunk phasors + closed-form type-2 smoothing (pll.pilot_open_run) —
    # zero sequential ops, batches over whole dispatches; "pll" = the
    # reference-shaped Q=500 biquad BP + chunked PLL scan
    pilot_alg: str = static_field(default="open")
    pilot_open: pll.PilotOpenConfig = static_field(default=None)
    # pilot notch: skipped when the audio LP already puts >= 55 dB on
    # 19 kHz (computed at design time) — the notch would be a no-op
    notch_needed: bool = static_field(default=True)

    # composite decimation BETWEEN the discriminator and the stereo tail:
    # the hq geometry (receiver.cpp:211-218 parity) only needs its ~512 kHz
    # rate for ALIAS-FREE DISCRIMINATION of the full +-200 kHz signal; the
    # demodulated composite itself is < 61 kHz wide (mono 0-15k, pilot 19k,
    # L-R 23-53k, RDS 57k +- 2.4k), so a relaxed halfband brings the tail
    # back to the tuned 256 kHz geometry's cost while the separation the
    # wide front bought is untouched.  cfg.sample_rate is the TAIL rate;
    # the discriminator runs at sample_rate * comp_decim.
    comp_decim: int = static_field(default=1)
    comp_taps: np.ndarray = static_field(default=None)

    # mono pre-discriminator LP: the reference mono path filters the complex
    # composite with a 75 kHz Q=1 RBJ lowpass biquad BEFORE the discriminator
    # (demod_wfm.cpp:166,210-212; active only when the demod rate is >=150k
    # so the IIR stays stable), re/im rails independently like
    # CIir::ProcessFilter's CPX overload.  The stereo path has no such
    # filter.  Being pre-nonlinearity it is NOT equalizable after the fact —
    # omitting it measured 61.6 dB vs the reference binary; with it the mono
    # row joins the stereo path's 90+ dB.
    mono_pre_lp: iir.BiquadCoef | None = static_field(default=None)

    @property
    def audio_rate(self) -> float:
        return self.sample_rate / self.audio_decim

    @property
    def input_rate(self) -> float:
        return self.sample_rate * self.comp_decim

    @staticmethod
    def make(sample_rate: float, stereo: bool = True, deemphasis_us: float = 75.0,
             audio_decim: int = 4, rds_tap: bool = False,
             pilot_alg: str = "open", comp_decim: int = 1) -> "WFMConfig":
        # stereo: put the LP stopband at the 19 kHz pilot so the separate
        # pilot notch becomes redundant (one fewer IIR pass).  Mono
        # keeps the wide transition (reference mono has no notch either,
        # demod_wfm.cpp:207-232).
        transition = (PILOT_HZ - 15000.0 if stereo
                      else sample_rate / (2.0 * audio_decim) - 15000.0)
        audio_taps = fir.design_lowpass_kaiser(
            15000.0, sample_rate, atten_db=60.0,
            transition_hz=transition, max_taps=255)
        # does the LP already kill the 19 kHz pilot residue?  (with the
        # 15 kHz/60 dB design it does; the reference's separate pilot notch,
        # demod_wfm.cpp:361-363, exists because its LP is gentler)
        h19 = np.abs(np.sum(audio_taps * np.exp(
            -2j * np.pi * PILOT_HZ / sample_rate * np.arange(len(audio_taps)))))
        fs_in = sample_rate * comp_decim
        mono_pre_lp = (iir.design_biquad("lowpass", 75000.0, fs_in, q=1.0)
                       if (not stereo and fs_in >= 150000.0) else None)
        comp_taps = None
        if comp_decim > 1:
            # relaxed decimator for the demodulated composite: pass 0-61 kHz
            # flat (RDS upper edge), stop everything that would alias INTO
            # that band (>= input_rate/comp_decim - 61 kHz).  At the hq
            # geometry (512k -> 256k) this is a ~0.12*fs-passband halfband —
            # a handful of taps, response-asserted in tests
            import scipy.signal as _ss

            pass_hz, alias_hz = 61000.0, sample_rate - 61000.0
            ntaps = 31
            comp_taps = _ss.remez(
                ntaps, [0.0, pass_hz, alias_hz, 0.5 * fs_in],
                [1.0, 0.0], weight=[1.0, 30.0], fs=fs_in)
            comp_taps = comp_taps / comp_taps.sum()
        return WFMConfig(
            sample_rate=sample_rate, stereo=stereo, deemphasis_us=deemphasis_us,
            audio_decim=audio_decim,
            audio_taps=audio_taps,
            pilot_bp=iir.design_biquad("bandpass", PILOT_HZ, sample_rate, q=500.0),
            # the notch runs on the DECIMATED audio stream — design it at the
            # audio rate (a composite-rate design applied at audio rate lands
            # at 19000/audio_decim Hz and notches program audio)
            pilot_notch=iir.design_biquad("notch", PILOT_HZ,
                                          sample_rate / audio_decim, q=5.0),
            pilot_pll=pll.make_pll_config(sample_rate, bw_hz=10.0, zeta=0.707,
                                          center_hz=PILOT_HZ, range_hz=100.0,
                                          detector="pilot"),
            rds_tap=rds_tap,
            pilot_alg=pilot_alg,
            pilot_open=pll.make_pilot_open_config(sample_rate),
            notch_needed=bool(h19 > 10.0 ** (-55.0 / 20.0)),
            comp_decim=comp_decim, comp_taps=comp_taps,
            mono_pre_lp=mono_pre_lp,
        )


@pytree_dataclass
class WFMState:
    last: jax.Array          # [C] previous sample for the discriminator
    pilot_bq: jax.Array      # [C, 2] pilot bandpass biquad state
    pilot_pll: pll.PLLState
    pilot_level: jax.Array   # [C] EWMA pilot amplitude (stereo lock detect)
    deemph_l: jax.Array      # [C]
    deemph_r: jax.Array      # [C]
    lp_tail_mono: jax.Array  # [C, T-1]
    lp_tail_lmr: jax.Array   # [C, T-1]
    notch_l: jax.Array       # [C, 2]
    notch_r: jax.Array       # [C, 2]
    comp_tail: jax.Array     # [C, Tc-1] composite-decimator history
    #                          (comp_decim > 1 only; else [C, 0])
    mono_lp_bq: jax.Array    # [2C, 2] mono pre-discriminator biquad state
    #                          (re rails then im rails; [0, 2] when unused)


def pilot_chunk_for(cfg: WFMConfig, n_block: int) -> int:
    """The open-pilot chunk length actually used at block length n_block
    (adapts down by halving until it divides the block)."""
    ell = cfg.pilot_open.chunk
    while n_block % ell:
        ell //= 2
    return ell


def wfm_init(cfg: WFMConfig, channels: int) -> WFMState:
    t = len(cfg.audio_taps)
    return WFMState(
        last=jnp.zeros((channels,), jnp.complex64),
        pilot_bq=iir.biquad_state_init(channels),
        pilot_pll=(pll.pilot_open_init(channels) if cfg.pilot_alg == "open"
                   else pll.pll_init(cfg.pilot_pll, channels)),
        pilot_level=jnp.zeros((channels,), jnp.float32),
        deemph_l=jnp.zeros((channels,), jnp.float32),
        deemph_r=jnp.zeros((channels,), jnp.float32),
        lp_tail_mono=fir.fir_tail_init(channels, t, jnp.float32),
        lp_tail_lmr=fir.fir_tail_init(channels, t, jnp.float32),
        notch_l=iir.biquad_state_init(channels),
        notch_r=iir.biquad_state_init(channels),
        comp_tail=jnp.zeros(
            (channels,
             len(cfg.comp_taps) - 1 if cfg.comp_decim > 1 else 0),
            jnp.float32),
        mono_lp_bq=iir.biquad_state_init(
            2 * channels if cfg.mono_pre_lp is not None else 0),
    )


def discriminator(last: jax.Array, x: jax.Array, gain: float):
    """conj-product FM discriminator; returns (new_last, fm [C, N] float32)."""
    prev = jnp.concatenate([last[:, None], x[:, :-1]], axis=-1)
    delta = x * jnp.conj(prev)
    return x[:, -1], jnp.arctan2(delta.imag, delta.real) * gain


def _ewma_rows(prev: jax.Array, p: jax.Array, a: float):
    """Per-block EWMA over the trailing axis of p [C, K], seeded by prev [C]:
    one tiny closed-form matmul instead of a K-step scan (the batched
    step_many analog of the per-call `a*level + (1-a)*coh` update)."""
    k = p.shape[-1]
    kk = np.arange(k)
    lmat = np.where(kk[:, None] <= kk[None, :],
                    (1.0 - a) * a ** (kk[None, :] - kk[:, None]), 0.0)
    with jax.ensure_compile_time_eval():
        lmat_d = jnp.asarray(lmat.astype(np.float32))
        seed_d = jnp.asarray((a ** (kk + 1)).astype(np.float32))
    return (jnp.matmul(p, lmat_d, precision=DOT_PRECISION)
            + prev[:, None] * seed_d[None, :])


def wfm_demod(cfg: WFMConfig, state: WFMState, x: jax.Array,
              n_block: int = 0):
    """x: [C, N] complex64 composite-rate IQ.

    n_block > 0 treats x as K = N // n_block concatenated logical blocks in
    ONE call (the batched step_many path): every stage is streaming-exact on
    the concatenated stream (FIR tails, biquads, deemphasis; the blockwise
    pilot PLL matches sequential calls to ~1e-3 rad — fp32 ramp precision),
    and the per-block pilot lock EWMA keeps its per-call semantics via a
    closed-form K-matmul.

    Returns (state', out) with out = dict(left [C, M], right [C, M],
    pilot_locked ([C] bool, or [C, K] when n_block), rds_baseband
    [C, N] complex64 | None) where M = N // audio_decim.
    """
    disc_gain = cfg.input_rate / (2.0 * np.pi * cfg.max_deviation)
    mono_bq = state.mono_lp_bq
    if cfg.mono_pre_lp is not None:
        # the reference mono path's 75 kHz pre-discriminator biquad
        # (demod_wfm.cpp:210-212): one stacked [2C, N] real biquad pass
        # over the re/im rails (CIir::ProcessFilter CPX overload semantics)
        c0 = x.shape[0]
        ri = jnp.concatenate([x.real, x.imag], axis=0)
        mono_bq, ri = iir.biquad_apply(state.mono_lp_bq, ri, cfg.mono_pre_lp)
        x = jax.lax.complex(ri[:c0], ri[c0:])
    new_last, raw = discriminator(state.last, x, disc_gain)  # [C, N] composite
    comp_tail = state.comp_tail
    if cfg.comp_decim > 1:
        # hq geometry: discriminate at input_rate, then bring the (<61 kHz
        # wide) composite down to the tail rate — the stereo tail costs
        # what the tuned geometry's does
        raw, comp_tail = fir.fir_apply_real_signal(
            raw, jnp.asarray(cfg.comp_taps, jnp.float32), state.comp_tail,
            decim=cfg.comp_decim, taps_np=np.asarray(cfg.comp_taps))
        if n_block:
            n_block = n_block // cfg.comp_decim

    taps = jnp.asarray(cfg.audio_taps, jnp.float32)
    alpha = iir.deemphasis_alpha(cfg.deemphasis_us, cfg.audio_rate)
    c = x.shape[0]
    n = raw.shape[-1]
    k_blocks = (n // n_block) if n_block else 1

    if cfg.stereo:
        # --- pilot recovery ---------------------------------------------------
        if cfg.pilot_alg == "open":
            # scan-free path: windowed chunk-DFT phasors + closed-form
            # smoothing (pll.pilot_open_run).  The Hann chunk window IS the
            # pilot bandpass, so the Q=500 biquad is not needed.  Chunk
            # length adapts down to divide the (logical) block length so
            # blockwise and batched calls see identical chunk grids.
            nb_ = n_block or n
            ell = pilot_chunk_for(cfg, nb_)
            pll_state, phases, level_f = pll.pilot_open_run(
                cfg.pilot_open, state.pilot_pll, raw, chunk=ell)
            bq_state = state.pilot_bq
            # lock level = smoothed coherent pilot amplitude (~A/2 locked);
            # per logical block, read it at the block's final chunk — same
            # threshold semantics as the PLL path's coherence EWMA
            fch = nb_ // ell
            if n_block:
                lv = level_f.reshape(c, k_blocks, fch)[:, :, -1]  # [C, K]
                level = lv[:, -1]
                locked = lv > 0.002                               # [C, K]
            else:
                level = level_f[:, -1]
                locked = level > 0.002                            # [C]
        else:
            bq_state, pilot = iir.biquad_apply(state.pilot_bq, raw,
                                               cfg.pilot_bp)
            # PLL expects a complex carrier; analytic-ify the narrowband
            # pilot by pairing it with its (approximate) quadrature via the
            # PLL itself: feed pilot as the real part; the 'cross' detector
            # uses Im(z)*sign(Re).
            pilot_c = pilot.astype(jnp.complex64)
            if cfg.pilot_chunk:
                pll_state, phases, _ = pll.pll_run_blockwise(
                    cfg.pilot_pll, state.pilot_pll, pilot_c,
                    chunk=cfg.pilot_chunk)
            else:
                pll_state, phases, _ = pll.pll_run(cfg.pilot_pll,
                                                   state.pilot_pll, pilot_c)
            # lock detect: coherent pilot amplitude.  The 'cross' PLL locks
            # with pilot ~= A*sin(phase), so pilot*sin(phase) averages to A/2
            # when locked and ~0 when unlocked (the demux below uses
            # sin(2*phase) accordingly, as the reference does in
            # demod_wfm.cpp:275-284).  (the sign() detector has two stable
            # lock points, pilot = +-A*sin(phi); both yield the same
            # sin(2*phi) demux, so lock on |coherence|)
            coh_s = pilot * jnp.sin(phases)
            if n_block:
                coh = jnp.abs(jnp.mean(coh_s.reshape(c, k_blocks, n_block),
                                       -1))
                level_k = _ewma_rows(state.pilot_level, coh, 0.9)  # [C, K]
                level = level_k[:, -1]
                locked = level_k > 0.002                           # [C, K]
            else:
                coh = jnp.abs(jnp.mean(coh_s, axis=-1))
                level = 0.9 * state.pilot_level + 0.1 * coh
                locked = level > 0.002                             # [C]
        # --- demux + decimating audio LP --------------------------------------
        lmr = raw * 2.0 * jnp.sin(2.0 * phases)  # L-R at baseband
        # mono + L-R share the same LP: ONE stacked [2C, N] banded-matmul
        # FIR (static taps_np enables the banded fast path)
        both, tails = fir.fir_apply_real_signal(
            jnp.concatenate([raw, lmr], axis=0), taps,
            jnp.concatenate([state.lp_tail_mono, state.lp_tail_lmr], axis=0),
            decim=cfg.audio_decim, taps_np=cfg.audio_taps)
        mono_a, lmr_a = both[:c], both[c:]
        tail_m, tail_s = tails[:c], tails[c:]
        if n_block:
            m_all = lmr_a.shape[-1]
            lmr_a = jnp.where(
                locked[:, :, None],
                lmr_a.reshape(c, k_blocks, m_all // k_blocks),
                0.0).reshape(c, m_all)
        else:
            lmr_a = jnp.where(locked[:, None], lmr_a, 0.0)
        left = mono_a + lmr_a
        right = mono_a - lmr_a
        # --- polish: pilot notch + de-emphasis --------------------------------
        # left/right share coefficients: one stacked [2C, M] pass each.
        # The notch is skipped when the audio LP already suppresses 19 kHz
        # by >= 55 dB (notch_needed, computed at design time)
        lr = jnp.concatenate([left, right], axis=0)
        if cfg.notch_needed:
            notch_lr, lr = iir.biquad_apply(
                jnp.concatenate([state.notch_l, state.notch_r], axis=0), lr,
                cfg.pilot_notch)
        else:
            notch_lr = jnp.concatenate([state.notch_l, state.notch_r], axis=0)
        d_lr, lr = iir.first_order_apply(
            jnp.concatenate([state.deemph_l, state.deemph_r], axis=0), lr,
            alpha, 1.0 - alpha)
        left, right = lr[:c], lr[c:]
        notch_l, notch_r = notch_lr[:c], notch_lr[c:]
        dl, dr = d_lr[:c], d_lr[c:]
    else:
        mono_a, tail_m = fir.fir_apply_real_signal(raw, taps, state.lp_tail_mono,
                                                   decim=cfg.audio_decim,
                                                   taps_np=cfg.audio_taps)
        dl, left = iir.first_order_apply(state.deemph_l, mono_a, alpha, 1.0 - alpha)
        right = left
        bq_state, pll_state = state.pilot_bq, state.pilot_pll
        level = state.pilot_level
        locked = (jnp.zeros((c, k_blocks), bool) if n_block
                  else jnp.zeros((c,), bool))
        tail_s, notch_l, notch_r = state.lp_tail_lmr, state.notch_l, state.notch_r
        dr = state.deemph_r

    rds_bb = None
    if cfg.rds_tap:
        # RDS premixes the -57 kHz shift INTO its decimation taps
        # (rds.RdsConfig.premix): ship the RAW REAL composite directly
        rds_bb = raw

    new_state = WFMState(
        last=new_last, pilot_bq=bq_state, pilot_pll=pll_state, pilot_level=level,
        deemph_l=dl, deemph_r=dr, lp_tail_mono=tail_m, lp_tail_lmr=tail_s,
        notch_l=notch_l, notch_r=notch_r, comp_tail=comp_tail,
        mono_lp_bq=mono_bq,
    )
    out = {"left": left, "right": right, "pilot_locked": locked,
           "rds_baseband": rds_bb}
    return new_state, out
