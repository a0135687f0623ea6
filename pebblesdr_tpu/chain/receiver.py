"""The receive chain: a jit-compiled, batched, stateful DSP graph.

Capability parity with Receiver (application/receiver.cpp):
  * chain construction from config (turnPowerOn :116-281) -> ReceiverConfig +
    Receiver.build(): plans decimation, block geometry, resampler, filters;
  * the hot loop (processIQData :758-1009) -> Receiver.step(): one jit call
    per [channels, frames] block: DC removal -> IQ balance -> noise blanker ->
    device-rate spectrum -> NCO mix -> decimator cascade -> zoomed spectrum ->
    FastFIR bandpass -> signal strength/squelch -> ANF -> AGC -> demod ->
    fractional resample -> audio gain/mute;
  * WFM branch (:854-902): mix -> WFM decimator (200 kHz protect) -> WFM
    stereo/RDS demod -> audio resample;
  * TestBench tap points (:296-318) -> `taps=True` returns named intermediate
    buffers;
  * squelch early-out (:891-897,959-965) -> branchless jnp.where gate on the
    frequency-domain SNR estimate.

Differences from the reference (deliberate):
  * [channels, block] batching: one Receiver instance demodulates C channels
    of one wideband capture concurrently (the reference is single-channel);
  * all per-block state is one explicit pytree (ReceiverState) — suspend /
    resume / checkpoint mid-stream is trivial (reference: scattered mutable
    members);
  * static block geometry: decimation factors and resampler ratios are fixed
    at build time so every shape is known to XLA (reference accumulates
    variable-length buffers at runtime, receiver.cpp:873-931);
  * runtime-tunable without recompile: tuning frequency, bandpass mask,
    squelch, gain, mute, IQ balance are *inputs* (RxParams), not constants.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core import db as dbu
from pebblesdr_tpu.core.block import pytree_dataclass
from pebblesdr_tpu.core.precision import DOT_PRECISION
from pebblesdr_tpu.demod import am as am_mod
from pebblesdr_tpu.demod import nfm as nfm_mod
from pebblesdr_tpu.demod import sam as sam_mod
from pebblesdr_tpu.demod import ssb as ssb_mod
from pebblesdr_tpu.demod import rds as rds_mod
from pebblesdr_tpu.demod import wfm as wfm_mod
from pebblesdr_tpu.demod.modes import MODE_INFO, DemodMode, is_wfm
from pebblesdr_tpu.ops import (agc, decimator, fastfir, front, iir, mixer,
                               resampler, scanops, signalstrength, spectrum)


# ----------------------------------------------------------------- config

@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    sample_rate: int                      # device sample rate (sps)
    frames_per_buffer: int = 32768        # input block length
    channels: int = 1
    mode: DemodMode = DemodMode.AM
    audio_rate: int = 48000
    spectrum_bins: int = 2048
    zoom_bins: int = 2048                 # demod-rate (HiRes) spectrum size,
    #                                       capped at the demod block length.
    #                                       Fixed like the reference's
    #                                       numHiResSpectrumBins (settings.h):
    #                                       display/S-meter cost must not grow
    #                                       with frames_per_buffer
    enable_noise_blanker: bool = False
    enable_anf: bool = False
    enable_dc_removal: bool = True        # front-end DC blocker.  Disable
    #                                       when the input is ALREADY at
    #                                       baseband with a legitimate DC
    #                                       carrier (the PFB bank's channel
    #                                       streams: a station on its channel
    #                                       center IS the DC term)
    enable_iq_balance: bool | str = False  # True: static params.iq_gain/
    #                                        iq_phase correction; "auto": the
    #                                        adaptive N4HY/dttsp image-reject
    #                                        iteration runs IN the chain with
    #                                        its weight carried in
    #                                        ReceiverState (iqbalance.cpp:65-87)
    agc_mode: str | None = None           # None -> mode default
    agc_stride: int = 1
    stereo: bool = True                   # FMS only
    rds: bool = False                     # WFM RDS tap
    rds_alg: str = "open"                 # RDS carrier recovery: "open" =
    #                                       scan-free squaring loop (batches
    #                                       over whole dispatches); "scan" =
    #                                       per-sample Costas lax.scan
    taps: bool = False                    # TestBench-style intermediate taps
    audio_lpf: bool = True
    batched_many: bool = True             # step_many as ONE straight-line
    #                                       graph (no lax.scan), parity-exact
    #                                       with K step() calls, for every
    #                                       mode batched_mode_ok admits; the
    #                                       others fall back to the scan
    batched_wfm: bool | None = None       # WFM through the batched step_many
    #                                       graph.  None = auto: ON whenever
    #                                       the pilot path is scan-free (the
    #                                       default "open" pilot, or mono) and
    #                                       there is no RDS bit-decode tap.
    #                                       With the legacy "pll" pilot the
    #                                       batched graph serializes the chunk
    #                                       scan across the whole dispatch and
    #                                       merely ties the scan path, so it
    #                                       stays opt-in there.
    db_offset: float = 0.0                # display calibration offset applied
    #                                       to both spectra (settings.h dbOffset)
    sam_sideband: str = "analytic"        # SAM sideband split: "analytic"
    #                                       (complex Hilbert BP, ~60 dB image
    #                                       rejection) or "rails" (the
    #                                       reference's exact per-rail phasing
    #                                       method, for parity vs the compiled
    #                                       reference — tools/refharness)
    ctcss_tone: float | None = None       # FMN only: CTCSS sub-audible tone
    #                                       squelch qualifier (goertzel.h:232-
    #                                       277 tables).  The squelch opens
    #                                       only when the SNR gate passes AND
    #                                       the configured tone dominates its
    #                                       neighbor tones (coherent EWMA
    #                                       integration, ops/goertzel.py)
    wfm_hq: bool = False                  # WFM composite geometry: False
    #                                       (default) demodulates at ~256 kHz
    #                                       (exactly the +-128 kHz Carson band
    #                                       of broadcast FM; ~35 dB stereo
    #                                       separation, the common SDR
    #                                       geometry); True protects the full
    #                                       +-200 kHz like the reference
    #                                       (~512k composite, 47.5 dB
    #                                       separation, ~1.5x chain cost)


@pytree_dataclass
class RxParams:
    """Runtime-tunable knobs — inputs to the jitted step, never recompile."""
    tune_hi: jax.Array     # [C] split-precision normalized tune freq (hi)
    tune_lo: jax.Array     # [C] (lo)
    bp_mask: jax.Array     # [2, 2*blk] float32 FastFIR mask (re, im planes)
    sm_band: jax.Array     # [blk] float32 signal-strength band mask
    sm_noise: jax.Array    # [blk] float32 noise side-window mask
    squelch_db: jax.Array  # scalar; -999 = always open
    gain: jax.Array        # scalar audio gain
    mute: jax.Array        # scalar bool
    iq_gain: jax.Array     # scalar IQ balance gain
    iq_phase: jax.Array    # scalar IQ balance phase


@pytree_dataclass
class ReceiverState:
    mixer: Any
    decim: Any
    fastfir: Any
    dc: Any
    nb: Any
    anf: Any
    agc: Any
    demod: Any
    resamp: Any
    spec_full: Any
    spec_zoom: Any
    rds: Any = None
    squelch: Any = None  # [C] bool: previous squelch decision (hysteresis)
    iqbal: Any = None    # adaptive IQ-balance weight (enable_iq_balance="auto")
    ctcss: Any = None    # CTCSS coherent-integration state (cfg.ctcss_tone)


class Receiver:
    """Build once per configuration; `step` is the jitted hot loop."""

    def __init__(self, cfg: ReceiverConfig):
        self.cfg = cfg
        info = MODE_INFO[cfg.mode]
        self.info = info
        fs = float(cfg.sample_rate)

        # --- decimation plan (receiver.cpp:192-218 capability) ---------------
        protect = info.max_output_bw
        if is_wfm(cfg.mode) and cfg.wfm_hq:
            # high-quality WFM: protect the full +-200 kHz so the composite
            # runs at ~512k (the reference geometry, receiver.cpp:211-218) —
            # measured stereo separation 47.5 dB vs 35 dB at the default
            # 256k composite, at ~1.5x the chain cost
            protect = 2.0 * info.max_output_bw
        self.plan = decimator.build_plan(fs, protect)
        if cfg.frames_per_buffer % self.plan.factor:
            raise ValueError(
                f"frames_per_buffer={cfg.frames_per_buffer} not divisible by "
                f"decimation factor {self.plan.factor}")
        self.demod_rate = int(self.plan.rate_out)
        self.blk = cfg.frames_per_buffer // self.plan.factor

        # --- demod config ----------------------------------------------------
        m = cfg.mode
        if is_wfm(m):
            # hq geometry: the ~512k rate is needed only for ALIAS-FREE
            # DISCRIMINATION; the demodulated composite is < 61 kHz wide, so
            # it decimates back to the tuned ~256k tail rate right after the
            # discriminator (WFMConfig.comp_decim) — full-separation front,
            # tuned-geometry tail cost
            self.wfm_comp_decim = (
                2 if (cfg.wfm_hq and self.demod_rate >= 400_000) else 1)
            tail_rate = self.demod_rate // self.wfm_comp_decim
            self.wfm_tail_blk = self.blk // self.wfm_comp_decim
            # decimate the audio path inside the demod so the fractional
            # resampler runs near 64 kHz instead of composite rate
            audio_decim = max(1, tail_rate // 64000)
            self.wfm_cfg = wfm_mod.WFMConfig.make(
                tail_rate, stereo=(m == DemodMode.FMS and cfg.stereo),
                rds_tap=cfg.rds, audio_decim=audio_decim,
                comp_decim=self.wfm_comp_decim)
            audio_src_rate = int(self.wfm_cfg.audio_rate)
            audio_blk = self.wfm_tail_blk // self.wfm_cfg.audio_decim
            if cfg.rds:
                self.rds_cfg = rds_mod.RdsConfig.make(tail_rate,
                                                      self.wfm_tail_blk,
                                                      alg=cfg.rds_alg)
            # batched WFM auto-resolution (see ReceiverConfig.batched_wfm):
            # ON when the pilot path is scan-free (open pilot, or mono) AND
            # the RDS carrier (if tapped) is the scan-free squaring loop —
            # i.e. the flagship WFM-stereo+RDS config batches by default
            if cfg.batched_wfm is None:
                self.batched_wfm = ((self.wfm_cfg.pilot_alg == "open"
                                     or not self.wfm_cfg.stereo)
                                    and (not cfg.rds
                                         or self.rds_cfg.alg == "open"))
            else:
                self.batched_wfm = bool(cfg.batched_wfm)
        else:
            self.batched_wfm = False
            audio_src_rate = self.demod_rate
            audio_blk = self.blk
            if m in (DemodMode.AM,):
                self.am_cfg = am_mod.AMConfig.make(self.demod_rate, info.default_filter)
            elif m == DemodMode.SAM:
                self.sam_cfg = sam_mod.SAMConfig.make(
                    self.demod_rate, info.default_filter,
                    sideband=cfg.sam_sideband)
            elif m == DemodMode.FMN:
                self.nfm_cfg = nfm_mod.NFMConfig.make(self.demod_rate)

        # --- resampler to audio rate (receiver.cpp:998-1004) ------------------
        self.rs_plan = resampler.plan(audio_src_rate, cfg.audio_rate, audio_blk)
        self.audio_blk = self.rs_plan.n_out

        # --- CTCSS tone squelch (FMN qualifier) -------------------------------
        if cfg.ctcss_tone is not None:
            if m != DemodMode.FMN:
                raise ValueError("ctcss_tone requires mode=FMN")
            from pebblesdr_tpu.ops import goertzel as _gz
            self._gz = _gz
            self.ctcss_cfg = _gz.CtcssConfig.make(
                cfg.ctcss_tone, float(cfg.audio_rate), self.audio_blk)
        else:
            self.ctcss_cfg = None

        # --- AGC --------------------------------------------------------------
        agc_mode = cfg.agc_mode if cfg.agc_mode is not None else info.agc_mode
        agc_stride = max(1, cfg.agc_stride)
        while self.blk % agc_stride:  # stride must divide the demod block
            agc_stride //= 2
        self.agc_cfg = agc.AGCConfig.make(self.demod_rate, agc_mode,
                                          stride=agc_stride)

        # --- spectra ----------------------------------------------------------
        w_full, cg_full = spectrum.make_window(cfg.spectrum_bins)
        self.w_full = jnp.asarray(w_full)
        self.cg_full = cg_full
        # HiRes/zoom spectrum size is FIXED (reference: numHiResSpectrumBins,
        # settings.h) — only the trailing zoom_bins demod samples feed the
        # display + S-meter transform, so its cost does not scale with
        # frames_per_buffer (a whole-block DFT is quadratic in block length)
        self.zoom_bins = min(self.blk, int(cfg.zoom_bins))
        w_zoom, cg_zoom = spectrum.make_window(self.zoom_bins)
        self.w_zoom = jnp.asarray(w_zoom)
        self.cg_zoom = cg_zoom

        # the front end's composed decimation FIR (ops.front): the whole
        # halfband cascade as one response (noble identity)
        self._front_h = decimator.compose_response(self.plan)
        # NB config: True -> NB1 'blank'; "average" -> NB2 substitution
        self._nb_params = None
        if cfg.enable_noise_blanker:
            nb_mode = ("average" if cfg.enable_noise_blanker == "average"
                       else "blank")
            self._nb_params = (3.3, 7, 0.001, nb_mode)

        self._step = jax.jit(self._step_impl, donate_argnums=(0,),
                             static_argnames=("spectra",))
        self._step_many = jax.jit(self._step_many_impl, donate_argnums=(0,),
                                  static_argnames=("spectra",))

    # ------------------------------------------------------------------ state

    def init_state(self) -> ReceiverState:
        c = self.cfg.channels
        m = self.cfg.mode
        if is_wfm(m):
            demod_state = wfm_mod.wfm_init(self.wfm_cfg, c)
            resamp_dtype = jnp.float32
        elif m == DemodMode.AM:
            demod_state = am_mod.am_init(self.am_cfg, c)
            resamp_dtype = jnp.float32
        elif m == DemodMode.SAM:
            demod_state = sam_mod.sam_init(self.sam_cfg, c)
            resamp_dtype = jnp.float32
        elif m == DemodMode.FMN:
            demod_state = nfm_mod.nfm_init(self.nfm_cfg, c)
            resamp_dtype = jnp.float32
        else:  # SSB/CW/DSB/DIG/NONE: stateless demod
            demod_state = None
            resamp_dtype = jnp.float32
        if is_wfm(m) and self.wfm_cfg.stereo:
            # stereo: resample L and R as 2C channels
            resamp_state = resampler.state_init(self.rs_plan, 2 * c, resamp_dtype)
        else:
            resamp_state = resampler.state_init(self.rs_plan, c, resamp_dtype)
        return ReceiverState(
            mixer=mixer.mixer_init(c),
            decim=front.hist_init(self.plan, c),
            fastfir=fastfir.state_init(c, self.blk),
            dc=jnp.zeros((c,), jnp.complex64),
            nb=(scanops.noise_blanker_chunked_init(c, self._nb_params[1])
                if self._nb_params is not None else None),
            anf=scanops.anf_init(c, dtype=jnp.complex64) if self.cfg.enable_anf else None,
            agc=agc.agc_init(self.agc_cfg, c),
            demod=demod_state,
            resamp=resamp_state,
            spec_full=spectrum.state_init(c, self.cfg.spectrum_bins),
            spec_zoom=spectrum.state_init(c, self.zoom_bins),
            rds=rds_mod.rds_init(self.rds_cfg, c) if self.cfg.rds else None,
            squelch=jnp.zeros((c,), bool),
            iqbal=(scanops.auto_iq_balance_init(c)
                   if self.cfg.enable_iq_balance == "auto" else None),
            ctcss=(self._gz.ctcss_init(c) if self.ctcss_cfg is not None
                   else None),
        )

    # ----------------------------------------------------------------- params

    def make_bandpass(self, lo_hz: float, hi_hz: float,
                      offset_hz: float | None = None):
        """Design the FastFIR mask + signal-strength masks (host-side).

        Returns (bp_mask [2, 2*blk] f32, sm_band [blk] f32, sm_noise [blk] f32);
        assign into RxParams (set_bandpass does it for you).

        Note: the mode table's lo/hi cuts already sit around the CW tone
        (e.g. CWU 600..1400 for the +1000 Hz offset), so the default extra
        offset is 0 — pass offset_hz explicitly for a RIT-style shift.
        """
        if offset_hz is None:
            offset_hz = 0.0
        mask_c = fastfir.design_mask(lo_hz, hi_hz, self.demod_rate,
                                     self.blk, offset_hz)
        mask = jnp.asarray(np.stack([mask_c.real, mask_c.imag]).astype(np.float32))
        band, noise = signalstrength.band_masks(lo_hz, hi_hz, self.demod_rate,
                                                self.zoom_bins)
        return mask, jnp.asarray(band), jnp.asarray(noise)

    def set_bandpass(self, params: "RxParams", lo_hz: float, hi_hz: float,
                     offset_hz: float | None = None) -> "RxParams":
        mask, band, noise = self.make_bandpass(lo_hz, hi_hz, offset_hz)
        return dataclasses.replace(params, bp_mask=mask, sm_band=band,
                                   sm_noise=noise)

    def default_params(self, tune_hz: float | np.ndarray = 0.0) -> RxParams:
        c = self.cfg.channels
        tunes = np.broadcast_to(np.asarray(tune_hz, np.float64), (c,))
        splits = [mixer.split_freq(t, self.cfg.sample_rate) for t in tunes]
        mask, band, noise = self.make_bandpass(self.info.lo_cut, self.info.hi_cut)
        return RxParams(
            tune_hi=jnp.asarray(np.stack([s[0] for s in splits])),
            tune_lo=jnp.asarray(np.stack([s[1] for s in splits])),
            bp_mask=mask,
            sm_band=band,
            sm_noise=noise,
            squelch_db=jnp.asarray(-999.0, jnp.float32),
            gain=jnp.asarray(1.0, jnp.float32),
            mute=jnp.asarray(False),
            iq_gain=jnp.asarray(1.0, jnp.float32),
            iq_phase=jnp.asarray(0.0, jnp.float32),
        )

    def retune(self, params: RxParams, tune_hz) -> RxParams:
        c = self.cfg.channels
        tunes = np.broadcast_to(np.asarray(tune_hz, np.float64), (c,))
        splits = [mixer.split_freq(t, self.cfg.sample_rate) for t in tunes]
        return dataclasses.replace(
            params,
            tune_hi=jnp.asarray(np.stack([s[0] for s in splits])),
            tune_lo=jnp.asarray(np.stack([s[1] for s in splits])))

    # ------------------------------------------------------------------- step

    def step(self, state: ReceiverState, params: RxParams, iq: jax.Array,
             spectra: bool = True):
        """One block: iq [C, frames_per_buffer] complex64, a
        [frames_per_buffer, 2C] float32 or int16 plane (re columns, then im
        columns — what feeders build when they deinterleave wire formats;
        int16 is the native-ADC container, dequantized at entry at
        1/32768), or a [2, frames_per_buffer, C] float32 plane pair.

        spectra=False skips the display spectra (the reference likewise
        computes them at updatesPerSecond, not per block —
        signalspectrum.cpp:63-86); squelch/S-meter still run.  Both variants
        are cached jit executables.

        Returns (state', outputs dict):
          audio       [C, audio_blk] float32 (or [C, 2, audio_blk] stereo)
          spectrum    [C, spectrum_bins] dB (device-rate, fftshifted) [spectra]
          zoomed      [C, blk] dB (demod-rate)                        [spectra]
          smeter      dict of [C] dB estimates
          squelch_open[C] bool
          (+ taps if cfg.taps)
        """
        return self._step(state, params, iq, spectra=spectra)

    def step_many(self, state: ReceiverState, params: RxParams, iq: jax.Array,
                  spectra: bool = True):
        """Process K blocks in ONE dispatch: iq [K*frames_per_buffer, 2C]
        float32 or int16 planes, [K, N, 2C] planes, an (re, im) pair of
        [K*N, C] planes, [K, 2, N, C] / [2, K, N, C] stacks, or [K, C, N]
        complex64.

        The state threads through exactly as with K step() calls; outputs
        gain a leading K axis.  Batchable configurations (batched_capable)
        run ONE straight-line graph over the whole dispatch; the others scan
        step() over the blocks.  Either way one dispatch amortizes the
        per-dispatch launch and transfer cost over K blocks.
        """
        return self._step_many(state, params, iq, spectra=spectra)

    @property
    def batched_mode_ok(self) -> bool:
        """The demod tail is expressible as one straight-line batched graph
        (independent of the front end — chain.pfb_bank reuses the batched
        TAIL behind its own filterbank front)."""
        batched_modes = (DemodMode.AM, DemodMode.USB, DemodMode.LSB,
                         DemodMode.CWU, DemodMode.CWL, DemodMode.DIGU,
                         DemodMode.DIGL, DemodMode.DSB, DemodMode.NONE)
        return bool(self.cfg.mode in batched_modes
                    or (is_wfm(self.cfg.mode) and self.batched_wfm
                        and (not self.cfg.rds
                             or self.rds_cfg.alg == "open"))
                    or (self.cfg.mode == DemodMode.FMN
                        and self.nfm_cfg.algorithm in ("conj", "derivative"))
                    or (self.cfg.mode == DemodMode.SAM
                        and self.sam_cfg.algorithm == "aimed"
                        and self.blk % 128 == 0))

    @property
    def batched_capable(self) -> bool:
        """True when step_many runs the straight-line batched graph.  The
        TestBench taps exist on the per-block path only."""
        # ANF does not force the scan path: the batched tail runs the
        # block-LMS with one weight update per logical block (vs per 16
        # samples scanned) — the same averaged-gradient algorithm at a
        # coarser cadence; see _tail_many
        return bool(self.cfg.batched_many and self.batched_mode_ok
                    and not self.cfg.taps)

    def _entry(self, iq, many: bool) -> jax.Array:
        """Any accepted entry layout -> [C, K*N] complex64 (K = 1 for step).
        int16 planes are dequantized here, full scale == 1.0."""
        c = self.cfg.channels
        if isinstance(iq, (tuple, list)):            # (re, im) planes
            re, im = iq
        elif jnp.iscomplexobj(iq):                   # [C, N] / [K, C, N]
            if iq.shape[-2] != c:
                raise ValueError(
                    f"complex input has {iq.shape[-2]} channels but this "
                    f"Receiver was built with channels={c}")
            x = jnp.moveaxis(iq, -2, 0) if iq.ndim == 3 else iq
            return x.reshape(c, -1).astype(jnp.complex64)
        elif iq.ndim == 4:                           # [K, 2, N, C] / [2, K, N, C]
            re, im = ((iq[:, 0], iq[:, 1]) if iq.shape[1] == 2
                      else (iq[0], iq[1]))
        elif iq.ndim == 3 and not many:              # [2, N, C]
            re, im = iq[0], iq[1]
        else:                                        # [(K*)N, 2C] / [K, N, 2C]
            if iq.shape[-1] != 2 * c:
                raise ValueError(
                    f"packed plane has {iq.shape[-1] / 2:g} channels but "
                    f"this Receiver was built with channels={c}")
            re, im = iq[..., :c], iq[..., c:]
        if re.shape[-1] != c:
            raise ValueError(f"input planes have {re.shape[-1]} channels but "
                             f"this Receiver was built with channels={c}")
        re = re.reshape(-1, c).astype(jnp.float32)
        im = im.reshape(-1, c).astype(jnp.float32)
        if jnp.issubdtype(iq[0].dtype if isinstance(iq, (tuple, list))
                          else iq.dtype, jnp.integer):
            re, im = re * (1.0 / 32768.0), im * (1.0 / 32768.0)
        return jax.lax.complex(re.T, im.T)

    def _front(self, state: ReceiverState, params: RxParams, x: jax.Array):
        """The full-rate front end over x [C, K*N] complex64 (K whole
        blocks): DC blocker -> IQ balance -> noise blanker -> NCO mix ->
        composed-FIR decimation (ops.front).  Returns (the front's
        ReceiverState fields, x [C, K*blk], the pre-mix stream — the
        TestBench raw_iq tap)."""
        cfg = self.cfg
        dc = state.dc
        if cfg.enable_dc_removal:
            dc, x = iir.dc_removal_chunked(state.dc, x, alpha=front.DC_ALPHA)
        iqbal_state = state.iqbal
        if cfg.enable_iq_balance == "auto":
            iqbal_state, x = scanops.auto_iq_balance(state.iqbal, x)
        elif cfg.enable_iq_balance:
            x = scanops.iq_balance(x, params.iq_gain, params.iq_phase)
        nb_state = state.nb
        if self._nb_params is not None:
            thr, bw, al, nb_mode = self._nb_params
            nb_state, x = scanops.noise_blanker_chunked(
                state.nb, x, threshold=thr, blank_width=bw, alpha=al,
                mode=nb_mode)
        pre_mix = x
        phase, x = front.mix_blocks(state.mixer.phase, x, params.tune_hi,
                                    params.tune_lo, cfg.frames_per_buffer)
        hist, x = front.decimate_composed(state.decim, x, self._front_h,
                                          self.plan.factor)
        fields = dict(mixer=mixer.MixerState(phase=phase), decim=hist, dc=dc,
                      nb=nb_state, iqbal=iqbal_state)
        return fields, x, pre_mix

    def _step_many_impl(self, state, params, iq, spectra=True):
        # Batchable configurations run the whole K-block dispatch as ONE
        # straight-line graph (no lax.scan): the front end once over the
        # concatenated stream, demod-rate tail ops once on [C, K*blk], and
        # the per-block quantities (spectra, S-meter, squelch) as
        # closed-form batched ops — the per-op launch cost is paid once per
        # dispatch instead of once per block.  Every op is streaming-exact
        # for any block length, so the result matches K step() calls.
        # SAM/FMN PLL demods, WFM with the "pll" pilot or the "scan" RDS
        # carrier, and TestBench taps take the scan (see batched_mode_ok).
        x = self._entry(iq, many=True)                   # [C, K*N]
        if self.batched_capable:
            return self._many_batched(state, params, x, spectra=spectra)
        n = self.cfg.frames_per_buffer
        blocks = jnp.moveaxis(x.reshape(self.cfg.channels, -1, n), 1, 0)

        def body(st, blk):
            return self._step_impl(st, params, blk, spectra=spectra)

        return jax.lax.scan(body, state, blocks)

    def _ewma_blocks(self, prev, p, a):
        """Closed-form per-block EWMA: avg_k = a*avg_{k-1} + (1-a)*p_k over
        the leading K axis, seeded by `prev` — one small matmul instead of a
        K-step scan.  p: [K, ...]; returns (avg [K, ...], avg_last)."""
        k = p.shape[0]
        kk = np.arange(k)
        lmat = np.where(kk[:, None] >= kk[None, :],
                        (1.0 - a) * a ** (kk[:, None] - kk[None, :]), 0.0)
        with jax.ensure_compile_time_eval():
            lmat_d = jnp.asarray(lmat.astype(np.float32))
            seed_d = jnp.asarray((a ** (kk + 1)).astype(np.float32))
        flat = p.reshape(k, -1)
        avg = (jnp.matmul(lmat_d, flat, precision=DOT_PRECISION)
               .reshape(p.shape)
               + seed_d.reshape((k,) + (1,) * (p.ndim - 1)) * prev[None])
        return avg, avg[-1]

    def _many_batched(self, state: ReceiverState, params: RxParams,
                      x: jax.Array, spectra: bool = True):
        """One straight-line graph for K blocks (see _step_many_impl):
        x [C, K*N] complex64 -> the front end once, then _tail_many."""
        c = self.cfg.channels
        n = self.cfg.frames_per_buffer
        k = x.shape[-1] // n
        raw_c = None
        if spectra:
            # device-rate display tails straight from the entry buffer
            bins = self.cfg.spectrum_bins
            raw_c = jnp.moveaxis(x.reshape(c, k, n)[:, :, n - bins:], 1, 0)
        front_st, x_dec, _ = self._front(state, params, x)
        tail_st, out = self._tail_many(state, params, k, raw_c, x_dec,
                                       spectra)
        return ReceiverState(**front_st, **tail_st), out

    def _tail_many(self, state: ReceiverState, params: RxParams, k: int,
                   raw_c, x_cat, spectra: bool = True):
        """The straight-line BATCHED demod-rate tail for K concatenated
        logical blocks: display spectra, S-meter/squelch, bandpass/AGC/demod/
        resample — everything downstream of a front end.  Used by
        _many_batched and by chain.pfb_bank's batched step_many (behind the
        filterbank front).

        raw_c: [K, C, spectrum_bins] complex device-rate display tails (or
        None when spectra=False); x_cat: [C, K*blk] demod-rate stream.
        Returns (tail_state_dict, out) where the dict carries the tail-owned
        ReceiverState fields."""
        cfg = self.cfg
        c = cfg.channels
        blk = self.blk
        out: dict[str, Any] = {}

        # ---- full-rate spectrum per block (batched) ------------------------
        if spectra:
            bins = raw_c.shape[-1]
            overload = jnp.max(jnp.abs(raw_c.real),
                               axis=-1) > spectrum.OVERLOAD_LEVEL
            xw = raw_c * self.w_full[None, None, :]
            norm = 1.0 / (bins * self.cg_full)
            p_full = (spectrum._shifted_power(xw.reshape(k * c, bins))
                      .reshape(k, c, bins) * (norm * norm))
            avg, avg_last = self._ewma_blocks(state.spec_full.avg_power,
                                              p_full, 0.5)
            out["spectrum"] = dbu.power_to_db(avg) + cfg.db_offset
            out["overload"] = overload
            spec_full_state = spectrum.SpectrumState(avg_power=avg_last)
        else:
            spec_full_state = state.spec_full

        # ---- zoom power + S-meter per block (batched) ----------------------
        # stay in the stream's native [C, K, n_z] order: the per-row DFT and
        # mask sums don't care about row order, so the [K, C, ·] relayout of
        # the whole demod-rate stream shrinks to a transpose of the tiny
        # [·, K, C] summary outputs — plus one [K, C, n_z] transpose at
        # display cadence only
        n_z = self.zoom_bins
        xz = x_cat.reshape(c, k, blk)[:, :, -n_z:]             # [C, K, n_z]
        xzw = xz * self.w_zoom[None, None, :]
        normz = 1.0 / (n_z * self.cg_zoom)
        power_lin = (spectrum._shifted_power(xzw.reshape(k * c, n_z))
                     .reshape(xz.shape) * (normz * normz))
        power_lin = power_lin * jnp.power(10.0, cfg.db_offset / 10.0)
        power_lin = jax.lax.optimization_barrier(power_lin)
        if spectra:
            zavg, zavg_last = self._ewma_blocks(
                state.spec_zoom.avg_power, jnp.moveaxis(power_lin, 1, 0), 0.5)
            out["zoomed"] = dbu.power_to_db(zavg)
            spec_zoom_state = spectrum.SpectrumState(avg_power=zavg_last)
        else:
            spec_zoom_state = state.spec_zoom
        sm = signalstrength.fd_estimate_masked(
            power_lin.reshape(k * c, n_z), params.sm_band, params.sm_noise)
        sm = {key: v.reshape(c, k).T for key, v in sm.items()}
        out["smeter"] = sm

        # ---- squelch with hysteresis: associative boolean recurrence -------
        # open_k = b_k | (a_k & open_{k-1});  b = snr>thr, a = snr>thr-3
        snr = sm["snr_db"]
        b_seq = snr > params.squelch_db
        a_seq = snr > params.squelch_db - 3.0

        def comb(x1, x2):
            a1, o1 = x1
            a2, o2 = x2
            return a1 & a2, o2 | (a2 & o1)

        pref_a, opens = jax.lax.associative_scan(comb, (a_seq, b_seq), axis=0)
        squelch_open = opens | (pref_a & state.squelch[None])
        out["squelch_open"] = squelch_open

        # ---- demod-rate tail ONCE on the concatenated stream ---------------
        m = cfg.mode
        if is_wfm(m):
            # WFM skips FastFIR/AGC (like _wfm_path); the demod runs the
            # whole K-block composite stream with per-block pilot-lock
            demod_state, wout = wfm_mod.wfm_demod(
                self.wfm_cfg, state.demod, x_cat, n_block=blk)
            out["pilot_locked"] = wout["pilot_locked"].T      # [K, C]
            ff_state, agc_state = state.fastfir, state.agc
            anf_state = state.anf
            if cfg.rds:
                # the scan-free RDS subchain (decimate -> resample -> squared
                # open-loop carrier -> matched filter) is streaming-exact on
                # the concatenated composite, so it runs ONCE per dispatch
                rds_state, soft, timing = rds_mod.rds_process(
                    self.rds_cfg, state.rds, wout["rds_baseband"])
                n_sym_b = soft.shape[-1] // k
                out["rds_soft"] = jnp.moveaxis(
                    soft.reshape(c, k, n_sym_b), 1, 0)         # [K, C, n_sym]
                out["rds_timing"] = jnp.broadcast_to(timing[None], (k, c))
            else:
                rds_state = state.rds
            if self.wfm_cfg.stereo:
                lr = jnp.concatenate([wout["left"], wout["right"]], axis=0)
                resamp_state, lr = resampler.apply_many(self.rs_plan,
                                                        state.resamp, lr)
                audio_blk = lr.shape[-1] // k
                lr = lr.reshape(2, c, k, audio_blk)           # [2, C, K, M]
                audio = jnp.moveaxis(lr, (2, 1), (0, 1))      # [K, C, 2, M]
            else:
                resamp_state, mono = resampler.apply_many(self.rs_plan,
                                                          state.resamp,
                                                          wout["left"])
                audio_blk = mono.shape[-1] // k
                audio = jnp.moveaxis(mono.reshape(c, k, audio_blk), 1, 0)
        else:
            rds_state = state.rds
            mask = jax.lax.complex(params.bp_mask[0], params.bp_mask[1])
            ff_state, xt = fastfir.apply_many(state.fastfir, x_cat, mask, blk)
            if cfg.enable_anf:
                # block-LMS at one update per logical block: K scan steps
                # per dispatch instead of K*blk/16 (the adaptation per
                # SAMPLE matches the scan path's averaged gradient; the
                # notch converges at the same rate, at block granularity)
                anf_state, xt = scanops.anf(state.anf, xt,
                                            update_every=blk)
            else:
                anf_state = state.anf
            agc_state, xt = agc.agc_apply(self.agc_cfg, state.agc, xt)
            if m == DemodMode.AM:
                demod_state, audio = am_mod.am_demod(self.am_cfg, state.demod,
                                                     xt)
            elif m == DemodMode.SAM:
                demod_state, audio = sam_mod.sam_demod(self.sam_cfg,
                                                       state.demod, xt,
                                                       n_block=blk)
            elif m == DemodMode.FMN:
                demod_state, audio = nfm_mod.nfm_demod(self.nfm_cfg,
                                                       state.demod, xt)
            elif m in (DemodMode.USB, DemodMode.CWU, DemodMode.DIGU):
                demod_state, audio = state.demod, ssb_mod.usb_demod(xt)
            elif m in (DemodMode.LSB, DemodMode.CWL, DemodMode.DIGL):
                demod_state, audio = state.demod, ssb_mod.lsb_demod(xt)
            elif m == DemodMode.DSB:
                demod_state, audio = state.demod, ssb_mod.dsb_demod(xt)
            else:
                demod_state, audio = state.demod, xt.real
            resamp_state, audio = resampler.apply_many(self.rs_plan,
                                                       state.resamp, audio)
            audio_blk = audio.shape[-1] // k
            audio = jnp.moveaxis(audio.reshape(c, k, audio_blk), 1, 0)

        # CTCSS squelch qualifier (FMN): one straight-line K-block update
        if self.ctcss_cfg is not None:
            ctcss_state, tone_open = self._gz.ctcss_update_many(
                self.ctcss_cfg, state.ctcss, audio)
            squelch_open = squelch_open & tone_open
            out["squelch_open"] = squelch_open
            out["ctcss_open"] = tone_open
        else:
            ctcss_state = state.ctcss

        gate = squelch_open.astype(jnp.float32) * params.gain * (
            1.0 - params.mute.astype(jnp.float32))
        out["audio"] = audio * gate[(...,) + (None,) * (audio.ndim - 2)]

        tail_st = dict(
            fastfir=ff_state, agc=agc_state, demod=demod_state,
            resamp=resamp_state, spec_full=spec_full_state,
            spec_zoom=spec_zoom_state, rds=rds_state,
            squelch=squelch_open[-1], ctcss=ctcss_state, anf=anf_state)
        return tail_st, out

    def _step_impl(self, state: ReceiverState, params: RxParams, iq: jax.Array,
                   spectra: bool = True):
        cfg = self.cfg
        out: dict[str, Any] = {}
        taps_out: dict[str, Any] = {}
        x = self._entry(iq, many=False)                  # [C, N] complex64

        # device-rate ("unprocessed") spectrum over the tail of the RAW input
        # block.  Slicing the entry buffer is free; slicing the dc-removed
        # stream makes XLA re-run the whole full-rate producer chain just for
        # the spectrum_bins-column consumer.
        if spectra:
            spec_full_state, full_db, overload = spectrum.averaged_spectrum(
                state.spec_full,
                x[:, -cfg.spectrum_bins:],
                self.w_full, self.cg_full, smoothing=0.5,
                db_offset=cfg.db_offset)
            out["spectrum"] = full_db
            out["overload"] = overload
        else:
            spec_full_state = state.spec_full

        # --- full-rate front end (receiver.cpp:814-826, 864-866, 910-911) ----
        front_st, x, pre_mix = self._front(state, params, x)
        if cfg.taps:
            taps_out["raw_iq"] = pre_mix
            taps_out["post_mixer"] = x

        # demod-rate (zoomed) power — always needed (squelch/S-meter source);
        # the dB display conversion + averaging only when spectra requested.
        # Only the trailing zoom_bins samples feed the transform (fixed-size
        # display/S-meter cost, see __init__).
        n_z = self.zoom_bins
        xw = x[:, -n_z:] * self.w_zoom[None, :]
        norm = 1.0 / (n_z * self.cg_zoom)
        power_lin = spectrum._shifted_power(xw) * (norm * norm)
        power_lin = power_lin * jnp.power(10.0, cfg.db_offset / 10.0)
        # keep the DFT matmuls as matmuls: without this barrier XLA fuses
        # them into the S-meter's masked reductions when the display path is
        # off, re-deriving the transform as elementwise code
        power_lin = jax.lax.optimization_barrier(power_lin)
        if spectra:
            a = 0.5
            avg = a * state.spec_zoom.avg_power + (1.0 - a) * power_lin
            spec_zoom_state = spectrum.SpectrumState(avg_power=avg)
            out["zoomed"] = dbu.power_to_db(avg)
        else:
            spec_zoom_state = state.spec_zoom

        # --- signal strength + squelch decision ------------------------------
        sm = signalstrength.fd_estimate_masked(power_lin, params.sm_band,
                                               params.sm_noise)
        out["smeter"] = sm
        # squelch with 3 dB hysteresis: once open, stays open until the SNR
        # falls 3 dB below the threshold (prevents chatter at the edge)
        snr = sm["snr_db"]
        squelch_open = jnp.where(state.squelch,
                                 snr > params.squelch_db - 3.0,
                                 snr > params.squelch_db)
        out["squelch_open"] = squelch_open

        rds_state = state.rds
        if is_wfm(cfg.mode):
            audio, demod_state, resamp_state, agc_state, anf_state, ff_state, rds_state = (
                self._wfm_path(state, x, taps_out, out))
        else:
            audio, demod_state, resamp_state, agc_state, anf_state, ff_state = (
                self._narrowband_path(state, params, x, taps_out))

        # --- CTCSS squelch qualifier (FMN, cfg.ctcss_tone) -------------------
        if self.ctcss_cfg is not None:
            ctcss_state, tone_open = self._gz.ctcss_update(
                self.ctcss_cfg, state.ctcss, audio)
            squelch_open = squelch_open & tone_open
            out["squelch_open"] = squelch_open
            out["ctcss_open"] = tone_open
        else:
            ctcss_state = state.ctcss

        # --- squelch gate + output gain/mute (branchless) --------------------
        gate = squelch_open.astype(jnp.float32) * params.gain * (
            1.0 - params.mute.astype(jnp.float32))
        if audio.ndim == 3:  # stereo [C, 2, M]
            audio = audio * gate[:, None, None]
        else:
            audio = audio * gate[:, None]
        out["audio"] = audio
        if cfg.taps:
            out["taps"] = taps_out

        new_state = ReceiverState(
            **front_st, fastfir=ff_state, anf=anf_state, agc=agc_state,
            demod=demod_state, resamp=resamp_state, spec_full=spec_full_state,
            spec_zoom=spec_zoom_state, rds=rds_state, squelch=squelch_open,
            ctcss=ctcss_state)
        return new_state, out

    # ---------------------------------------------------------- mode branches

    def _narrowband_path(self, state, params, x, taps_out):
        cfg = self.cfg
        # FastFIR bandpass (receiver.cpp:950)
        mask = jax.lax.complex(params.bp_mask[0], params.bp_mask[1])
        ff_state, x = fastfir.apply(state.fastfir, x, mask)
        if cfg.taps:
            taps_out["post_bp"] = x
        # ANF (receiver.cpp:974)
        if cfg.enable_anf:
            anf_state, x = scanops.anf(state.anf, x)
        else:
            anf_state = state.anf
        # AGC (receiver.cpp:983)
        agc_state, x = agc.agc_apply(self.agc_cfg, state.agc, x)
        # demod (receiver.cpp:987)
        m = cfg.mode
        if m == DemodMode.AM:
            demod_state, audio = am_mod.am_demod(self.am_cfg, state.demod, x)
        elif m == DemodMode.SAM:
            demod_state, audio = sam_mod.sam_demod(self.sam_cfg, state.demod, x)
        elif m == DemodMode.FMN:
            demod_state, audio = nfm_mod.nfm_demod(self.nfm_cfg, state.demod, x)
        elif m in (DemodMode.USB, DemodMode.CWU, DemodMode.DIGU):
            demod_state, audio = state.demod, ssb_mod.usb_demod(x)
        elif m in (DemodMode.LSB, DemodMode.CWL, DemodMode.DIGL):
            demod_state, audio = state.demod, ssb_mod.lsb_demod(x)
        elif m == DemodMode.DSB:
            demod_state, audio = state.demod, ssb_mod.dsb_demod(x)
        else:  # NONE: pass through I
            demod_state, audio = state.demod, x.real
        if cfg.taps:
            taps_out["post_demod"] = audio
        # resample to audio rate
        resamp_state, audio = resampler.apply(self.rs_plan, state.resamp, audio)
        return audio, demod_state, resamp_state, agc_state, anf_state, ff_state

    def _wfm_path(self, state, x, taps_out, out):
        cfg = self.cfg
        demod_state, wout = wfm_mod.wfm_demod(self.wfm_cfg, state.demod, x)
        out["pilot_locked"] = wout["pilot_locked"]
        rds_state = state.rds
        if cfg.rds:
            rds_state, soft, timing = rds_mod.rds_process(
                self.rds_cfg, state.rds, wout["rds_baseband"])
            out["rds_soft"] = soft
            out["rds_timing"] = timing
        if cfg.taps:
            taps_out["post_demod"] = wout["left"]
            if wout["rds_baseband"] is not None:
                taps_out["rds_baseband"] = wout["rds_baseband"]
        if self.wfm_cfg.stereo:
            # channel count from the data, not cfg: under a shard_map'd
            # tail (parallel.channelizer) this path sees only the local
            # channel shard
            c = wout["left"].shape[0]
            lr = jnp.concatenate([wout["left"], wout["right"]], axis=0)  # [2C, M]
            resamp_state, lr = resampler.apply(self.rs_plan, state.resamp, lr)
            audio = jnp.stack([lr[:c], lr[c:]], axis=1)  # [C, 2, M]
        else:
            resamp_state, audio = resampler.apply(self.rs_plan, state.resamp,
                                                  wout["left"])
        return (audio, demod_state, resamp_state, state.agc, state.anf,
                state.fastfir, rds_state)
