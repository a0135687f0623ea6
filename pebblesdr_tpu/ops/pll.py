"""Second-order phase-locked loops as lax.scan kernels.

One generic PLL engine serves every PLL in the reference:
  * SAM carrier recovery (demod_sam.cpp:5-112: BW 100 Hz, zeta .707, +-1 kHz)
  * NFM NCO-PLL discriminator (demod_nfm.cpp:225-257)
  * WFM 19 kHz stereo pilot PLL (demod_wfm.cpp:154-196,370+)
  * RDS 57 kHz subcarrier PLL (demod_wfm.cpp:301-317)

The loop is inherently sequential (phase error feeds back into the next
sample's NCO) so it runs as a lax.scan with per-channel scalar state — the
only truly serial op in the chain; everything around it is vectorized.  Loop
gains follow the standard 2nd-order design: alpha = 2*zeta*wn, beta = wn^2,
wn = 2*pi*BW/fs (same derivation the reference uses).

The phase detector is pluggable: 'atan2' (full four-quadrant, SAM/NFM) or
'cross' (Im(x * e^{-j\\phi}) small-angle product, pilot/RDS).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core.block import pytree_dataclass, static_field
from pebblesdr_tpu.core.precision import DOT_PRECISION

TWO_PI = 2.0 * math.pi


@pytree_dataclass
class PLLConfig:
    alpha: float = static_field()
    beta: float = static_field()
    freq_center: float = static_field()  # radians/sample NCO center
    freq_lo: float = static_field()      # radians/sample clamp
    freq_hi: float = static_field()
    detector: str = static_field(default="atan2")


def make_pll_config(sample_rate: float, bw_hz: float, zeta: float = 0.707,
                    center_hz: float = 0.0, range_hz: float = 1000.0,
                    detector: str = "atan2") -> PLLConfig:
    wn = TWO_PI * bw_hz / sample_rate
    norm = TWO_PI / sample_rate
    return PLLConfig(
        alpha=2.0 * zeta * wn,
        beta=wn * wn,
        freq_center=center_hz * norm,
        freq_lo=(center_hz - range_hz) * norm,
        freq_hi=(center_hz + range_hz) * norm,
        detector=detector,
    )


@pytree_dataclass
class PLLState:
    phase: jax.Array  # [C] radians
    fdev: jax.Array   # [C] radians/sample DEVIATION from freq_center — keeping
    #                   the integrator near zero preserves float32 precision
    #                   (beta*err increments are ~1e-9; adding them to an
    #                   absolute 0.2 rad/sample frequency underflows in f32)
    amp: jax.Array    # [C] EWMA of |input| (detector gain normalization)


def pll_init(cfg: PLLConfig, channels: int) -> PLLState:
    return PLLState(
        phase=jnp.zeros((channels,), jnp.float32),
        fdev=jnp.zeros((channels,), jnp.float32),
        amp=jnp.full((channels,), 1.0, jnp.float32),
    )


def pll_run(cfg: PLLConfig, state: PLLState, x: jax.Array):
    """Track the carrier in x [C, N] complex64.

    Returns (state', phases [C, N], freqs [C, N]) — per-sample NCO phase (the
    phase *used* to mix each sample) and the instantaneous loop frequency
    (absolute, radians/sample).  Callers build whatever they need from the
    phase (carrier removal, stereo demux sin(2*phase), FM audio from freq
    deviation, ...).
    """
    dev_lo = cfg.freq_lo - cfg.freq_center
    dev_hi = cfg.freq_hi - cfg.freq_center

    def step(carry, xt):  # xt: [C]
        phase, fdev, amp = carry
        amp2 = amp + 1e-3 * (jnp.abs(xt) - amp)
        if cfg.detector == "pilot":
            # real-signal PD: for x ~= A*sin(theta), x*cos(phi) low-passes to
            # (A/2)*sin(theta-phi); the 2w ripple is filtered by the narrow
            # loop (the CuteSDR pilot-PLL approach, demod_wfm.cpp:390+).
            # Locks with x ~= A*sin(phase).  Normalized by the tracked
            # amplitude so the loop bandwidth is independent of pilot level
            # (mean|A sin| = 2A/pi -> A/2 = (pi/4)*mean|x|).
            a_half = jnp.maximum((jnp.pi / 4.0) * amp2, 1e-6)
            err = xt.real * jnp.cos(phase) / a_half
        else:
            osc = jnp.exp(-1j * phase.astype(jnp.complex64))
            z = xt * osc
            if cfg.detector == "atan2":
                err = jnp.arctan2(z.imag, z.real)
            elif cfg.detector == "costas":
                # BPSK Costas loop (RDS subcarrier): Re*Im cancels the +-1
                # data modulation; normalized by the tracked power so loop
                # bandwidth is signal-level independent
                err = z.real * z.imag / jnp.maximum(amp2 * amp2, 1e-12)
            else:  # 'cross': small-angle product detector (complex carriers)
                err = z.imag * jnp.sign(z.real)
        fdev2 = jnp.clip(fdev + cfg.beta * err, dev_lo, dev_hi)
        phase2 = phase + (cfg.freq_center + fdev2) + cfg.alpha * err
        phase2 = jnp.mod(phase2 + jnp.pi, TWO_PI) - jnp.pi
        return (phase2, fdev2, amp2), (phase, fdev2)

    (ph, fr, am), (phases, fdevs) = jax.lax.scan(
        step, (state.phase, state.fdev, state.amp), jnp.moveaxis(x, 1, 0))
    return (PLLState(phase=ph, fdev=fr, amp=am),
            jnp.moveaxis(phases, 0, 1),
            jnp.moveaxis(fdevs, 0, 1) + cfg.freq_center)


def pll_run_blockwise(cfg: PLLConfig, state: PLLState, x: jax.Array,
                      chunk: int = 256):
    """Chunked PLL: coherent per-chunk phase estimation + a short scan.

    A per-sample scan at N ~ 10^4 is a long sequential loop on an
    accelerator (SURVEY.md §7 "chunked sequential-with-handoff").  For a
    narrowband carrier (loop bandwidth << fs/chunk) the per-sample loop is
    equivalent to: (1) derotate each chunk by the NCO center frequency and
    coherently sum -> one complex phasor per chunk (a matmul); (2) run the
    type-2 loop over CHUNKS (N/chunk scan steps); (3) reconstruct the
    per-sample phase as center-ramp + the chunk loop phase (piecewise, with
    the loop frequency advancing it within the chunk).

    Valid when loop BW * chunk / fs << 1 (pilot: 10 Hz * 256 / 512k = 5e-3).
    Detector: works for 'pilot' (real input; derotation uses the analytic
    trick Re[x]*e^{-jwt} whose mean is A/2 * e^{j(phi_x - phi_nco)}) and
    'atan2' (complex carriers).

    Returns (state', phases [C, N], freqs [C, N]) like pll_run.
    """
    c, n = x.shape
    assert n % chunk == 0
    f = n // chunk
    wc = cfg.freq_center
    # center-frequency derotation ramp, split per chunk; phase of sample
    # (k*chunk + t) is wc*(k*chunk + t): factor into chunk phase + in-chunk
    t_in = jnp.arange(chunk, dtype=jnp.float32)
    rot_in = jnp.exp(-1j * (wc * t_in))                       # [chunk]
    k_idx = jnp.arange(f, dtype=jnp.float32)
    rot_chunk = jnp.exp(-1j * (wc * chunk * k_idx))           # [f]
    xc = x.reshape(c, f, chunk)
    if cfg.detector == "pilot":
        xin = xc.real.astype(jnp.complex64)
    else:
        xin = xc
    z = jnp.einsum("cfk,k->cf", xin, rot_in,
                   precision=DOT_PRECISION) * rot_chunk[None, :] / chunk

    alpha = cfg.alpha * chunk      # loop gains rescale to the chunk rate
    beta = cfg.beta * chunk * chunk
    dev_lo = (cfg.freq_lo - wc) * chunk
    dev_hi = (cfg.freq_hi - wc) * chunk

    def step(carry, zk):
        phase, fdev, amp = carry       # phase: loop phase offset (radians)
        amp2 = amp + 0.05 * (jnp.abs(zk) - amp)
        zz = zk * jnp.exp(-1j * phase)
        if cfg.detector == "pilot":
            # pilot = A sin(wc t + psi) derotates to (A/2) e^{j(psi - pi/2)};
            # rotate by +pi/2 so lock lands at phase = psi, matching the
            # per-sample 'pilot' detector convention (pilot ~ A sin(phase))
            zz = zz * 1j
        err = jnp.arctan2(zz.imag, zz.real)
        fdev2 = jnp.clip(fdev + beta * err, dev_lo, dev_hi)
        phase2 = phase + fdev2 + alpha * err
        phase2 = jnp.mod(phase2 + jnp.pi, TWO_PI) - jnp.pi
        return (phase2, fdev2, amp2), (phase, fdev2)

    carry0 = (state.phase, state.fdev * chunk, state.amp)
    (ph, fr, am), (offs, fdevs) = jax.lax.scan(step, carry0,
                                               jnp.moveaxis(z, 1, 0))
    offs = jnp.moveaxis(offs, 0, 1)        # [C, F] loop phase at chunk start
    fdevs = jnp.moveaxis(fdevs, 0, 1)      # [C, F] rad per CHUNK deviation
    # reconstruct per-sample phase: center ramp + loop offset + in-chunk drift
    center_ramp = (wc * chunk) * k_idx[None, :, None] + wc * t_in[None, None, :]
    in_chunk = (fdevs / chunk)[:, :, None] * t_in[None, None, :]
    phases = center_ramp + offs[:, :, None] + in_chunk
    phases = phases.reshape(c, n)
    freqs = (wc + fdevs[:, :, None] / chunk
             * jnp.ones_like(t_in)[None, None, :]).reshape(c, n)
    new_state = PLLState(phase=ph, fdev=fr / chunk, amp=am)
    return new_state, phases, freqs


def pll_run_aimed(cfg: PLLConfig, state, aim_phase: jax.Array,
                  x: jax.Array, chunk: int = 64, n_block: int = 0,
                  smooth_cfg=None):
    """Two-stage blockwise PLL for WIDE pull ranges (SAM: +-1 kHz at ~30 ksps,
    where pll_run_blockwise's fixed-center chunk sums lose coherence).

    Stage 1 AIMS: the block's carrier frequency comes from the conj-product
    mean (one reduction — the discriminator trick), clipped to the loop
    range; the block is derotated by the carried aim ramp.  Stage 2 runs the
    chunked blockwise loop on the (now near-zero) residual.  The aim phase
    carries across calls so the reconstructed phase is continuous.

    n_block > 0 computes the aim per logical block of the concatenated
    stream (the batched step_many path) with a closed-form carried-phase
    cumsum — matches sequential calls up to fp32 ramp precision.

    smooth_cfg (a CostasOpenConfig; state must then be a CostasOpenState)
    replaces the stage-2 chunked loop SCAN with the OPEN-LOOP tracker
    (costas_open_run square=False): the residual after aiming is a strong
    near-DC carrier, and symmetric AM scales the chunk phasors' magnitude
    only, so the open estimate is unbiased — and the last sequential op in
    the SAM chain disappears.

    Returns (state', aim_phase' [C], phases [C, N], freqs [C, N] rad/sample).
    """
    c, n = x.shape
    nb = n_block or n
    k = n // nb
    # ---- stage 1: per-block carrier frequency, multi-resolution aim.
    # A plain conj-product mean is biased by strong sidebands (an AM signal's
    # sideband pulls the estimate hundreds of Hz); instead, progressively
    # longer coherent sums act as boxcar lowpass stages that attenuate the
    # sidebands before each frequency read, while each read's unambiguous
    # range (|f*span| < pi) still covers the previous stage's residual.
    z = x.reshape(c, k, nb)
    f_est = jnp.zeros((c, k), jnp.float32)
    span = 1
    for fold in (8, 4, 4):
        z = jnp.sum(z.reshape(c, k, -1, fold), axis=-1)         # [C, K, M]
        span *= fold
        # within-block products only, so the K-block batched call computes
        # the exact same per-block aim as K sequential calls
        dm = jnp.mean(z[:, :, 1:] * jnp.conj(z[:, :, :-1]), axis=-1)
        f_step = jnp.arctan2(dm.imag, dm.real) / span           # rad/sample
        f_est = f_est + f_step
        # derotate the summed stream by this stage's estimate so the next
        # (longer) coherent sum sees the carrier near DC
        m_idx = jnp.arange(z.shape[-1], dtype=jnp.float32)
        rot = (f_step[:, :, None] * span) * m_idx[None, None, :]
        z = z * jnp.exp(-1j * rot.astype(jnp.complex64))
    f_est = jnp.clip(f_est, cfg.freq_lo, cfg.freq_hi)
    # carried aim phase at each block start: aim + cumsum(f_est * nb)
    steps = f_est * float(nb)
    starts = aim_phase[:, None] + jnp.concatenate(
        [jnp.zeros((c, 1), jnp.float32), jnp.cumsum(steps[:, :-1], axis=-1)],
        axis=-1)                                                # [C, K]
    starts = jnp.mod(starts + math.pi, TWO_PI) - math.pi
    t_in = jnp.arange(nb, dtype=jnp.float32)
    ramp = (starts[:, :, None] + f_est[:, :, None] * t_in[None, None, :]
            ).reshape(c, n)
    xd = x * jnp.exp(-1j * ramp.astype(jnp.complex64))
    if smooth_cfg is not None:
        ell = smooth_cfg.chunk
        while nb % ell:
            ell //= 2
        st2, ph_res, _ = costas_open_run(smooth_cfg, state, xd, chunk=ell,
                                         square=False)
        fr_res = jnp.zeros_like(ph_res)
    else:
        cfg0 = PLLConfig(alpha=cfg.alpha, beta=cfg.beta, freq_center=0.0,
                         freq_lo=cfg.freq_lo - cfg.freq_hi,
                         freq_hi=cfg.freq_hi - cfg.freq_lo,
                         detector=cfg.detector)
        st2, ph_res, fr_res = pll_run_blockwise(cfg0, state, xd, chunk=chunk)
    phases = ramp + ph_res
    freqs = jnp.repeat(f_est, nb, axis=-1) + fr_res
    aim2 = jnp.mod(starts[:, -1] + steps[:, -1] + math.pi, TWO_PI) - math.pi
    return st2, aim2, phases, freqs


# ------------------------------------------------------- open-loop pilot (WFM)

@pytree_dataclass
class PilotOpenConfig:
    """Scan-free pilot recovery: windowed chunk-DFT phasors + closed-form
    type-2 smoothing (freq EWMA + integrated-dev cumsum + residual-phasor
    EWMA).  Replaces the Q=500 pilot biquad + chunked PLL of the reference
    path (demod_wfm.cpp:154-196,370+) with the same capability — 19 kHz
    carrier tracking at ~10 Hz loop bandwidth over a +-range_hz pull range —
    but with ZERO sequential ops: every stage is a matmul, cumsum, or
    elementwise op, so it batches over a whole multi-block dispatch."""
    freq_center: float = static_field()   # rad/sample (the 19 kHz ramp)
    dev_max: float = static_field()       # rad/sample clamp on the freq est
    chunk: int = static_field(default=256)
    bw_hz: float = static_field(default=10.0)      # loop bandwidth
    sample_rate: float = static_field(default=0.0)  # for alpha recompute
    #   The EWMA alphas are recomputed from the ACTUAL chunk length inside
    #   pilot_open_core (a = exp(-2*pi*bw*ell/fs)) so a runtime chunk
    #   override — wfm_demod adapts ell down when the block length is not
    #   divisible by 256 — keeps the configured loop bandwidth instead of
    #   silently scaling it by chunk/ell.


def make_pilot_open_config(sample_rate: float, pilot_hz: float = 19000.0,
                           range_hz: float = 100.0, bw_hz: float = 10.0,
                           chunk: int = 256) -> PilotOpenConfig:
    wc = TWO_PI * pilot_hz / sample_rate
    return PilotOpenConfig(freq_center=wc,
                           dev_max=TWO_PI * range_hz / sample_rate,
                           chunk=chunk, bw_hz=bw_hz,
                           sample_rate=float(sample_rate))


@pytree_dataclass
class PilotOpenState:
    z_prev: jax.Array  # [C] complex64: previous chunk phasor (ramp-referenced)
    dw: jax.Array      # [C] f32: freq deviation estimate, rad/sample
    psi: jax.Array     # [C] f32: integrated deviation phase at next chunk
    r: jax.Array       # [C] complex64: smoothed residual phasor
    base: jax.Array    # [C] f32: wc ramp phase at next sample (mod 2pi)


def pilot_open_init(channels: int) -> PilotOpenState:
    # distinct buffers per leaf: the chain donates its state pytree, and
    # donating one aliased buffer twice is an XLA error
    return PilotOpenState(z_prev=jnp.zeros((channels,), jnp.complex64),
                          dw=jnp.zeros((channels,), jnp.float32),
                          psi=jnp.zeros((channels,), jnp.float32),
                          r=jnp.zeros((channels,), jnp.complex64),
                          base=jnp.zeros((channels,), jnp.float32))


def _ewma_closed(prev: jax.Array, p: jax.Array, a: float) -> jax.Array:
    """y_k = a*y_{k-1} + (1-a)*p_k over the trailing axis of p [C, K],
    seeded by prev [C] — ONE [K, K] matmul instead of a K-step scan.
    Real or complex."""
    k = p.shape[-1]
    kk = np.arange(k)
    lmat = np.where(kk[:, None] <= kk[None, :],
                    (1.0 - a) * a ** (kk[None, :] - kk[:, None]), 0.0)
    seed = a ** (kk + 1)
    with jax.ensure_compile_time_eval():
        lmat_d = jnp.asarray(lmat.astype(np.float32))
        seed_d = jnp.asarray(seed.astype(np.float32))
    if jnp.iscomplexobj(p):
        re = jnp.matmul(p.real, lmat_d, precision=DOT_PRECISION) \
            + prev.real[..., None] * seed_d
        im = jnp.matmul(p.imag, lmat_d, precision=DOT_PRECISION) \
            + prev.imag[..., None] * seed_d
        return jax.lax.complex(re, im)
    return jnp.matmul(p, lmat_d, precision=DOT_PRECISION) + prev[..., None] * seed_d


def pilot_open_core(cfg: PilotOpenConfig, state: PilotOpenState,
                    raw: jax.Array, chunk: int | None = None):
    """Track the 19 kHz pilot in raw [C, N] float32 composite.

    Per chunk of L samples: (1) Hann-windowed DFT bin at freq_center -> one
    phasor z_f (matmul; the window IS the pilot bandpass — L-R sidebands and
    program audio land >= 2 bins away where the Hann kernel nulls);
    (2) chunk-to-chunk conj product -> frequency measurement, EWMA-smoothed
    (closed-form matmul); (3) integrated deviation phase via cumsum;
    (4) residual phasor z*e^{-j psi}, EWMA-smoothed -> phase + lock level.
    Per-sample phase = wc ramp + integrated deviation + smoothed residual
    angle, linear within each chunk.  Streaming-exact for any blocking of
    the input (all smoothers are seeded closed forms).

    Returns (state', (p0 [C, F], wf [C, F], t_in [L]), level [C, F]):
    the per-sample pilot phase is p0[c, f] + wf[c, f]*t for sample fL + t,
    following the 'pilot' PLL convention (pilot ~= A*sin(phase) when locked;
    demux uses sin(2*phase)); `level` is the smoothed coherent pilot
    amplitude (~A/2 when locked) per chunk.
    """
    c, n = raw.shape
    ell = int(chunk or cfg.chunk)
    assert n % ell == 0, (n, ell)
    f = n // ell
    wc = cfg.freq_center
    # loop-bandwidth-preserving EWMA coefficient at the ACTUAL chunk rate
    # (see PilotOpenConfig: ell may differ from cfg.chunk at runtime)
    fs = cfg.sample_rate or (TWO_PI * 19000.0 / wc)
    alpha = math.exp(-TWO_PI * cfg.bw_hz * ell / fs)
    t_in = np.arange(ell, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * t_in / ell)   # periodic Hann
    win = win / win.sum()
    mat = win * np.exp(-1j * wc * t_in)
    ramp_f = np.mod(wc * ell * np.arange(f, dtype=np.float64), 2 * np.pi)
    with jax.ensure_compile_time_eval():
        mat_d = jnp.asarray(np.stack([mat.real, mat.imag], axis=1)
                            .astype(np.float32))          # [L, 2]
        rotf_c = jnp.asarray(np.cos(ramp_f).astype(np.float32))   # [F]
        rotf_s = jnp.asarray(np.sin(ramp_f).astype(np.float32))
        ramp_d = jnp.asarray(ramp_f.astype(np.float32))   # [F]
        tin_d = jnp.asarray(t_in.astype(np.float32))      # [L]
    zz = jnp.matmul(raw.reshape(c, f, ell), mat_d,
                    precision=DOT_PRECISION)                  # [C, F, 2]
    z = jax.lax.complex(zz[..., 0], zz[..., 1])
    rotf = jax.lax.complex(rotf_c, -rotf_s)               # e^{-j ramp_f}
    z = z * rotf[None, :] * jnp.exp(-1j * state.base)[:, None]

    # frequency: conj product between successive chunk phasors
    zprev = jnp.concatenate([state.z_prev[:, None], z[:, :-1]], axis=1)
    d = z * jnp.conj(zprev)
    dwm = jnp.clip(jnp.arctan2(d.imag, d.real) / ell,
                   -cfg.dev_max, cfg.dev_max)
    dw = _ewma_closed(state.dw, dwm, alpha)               # [C, F]

    # integrated deviation phase at chunk starts (exclusive cumsum, seeded)
    cs = jnp.cumsum(dw, axis=-1)
    psi = state.psi[:, None] + ell * (cs - dw)            # [C, F]
    psi_next = state.psi + ell * cs[:, -1]

    # residual phasor, smoothed; its angle is the remaining phase offset
    rres = z * jnp.exp(-1j * psi)
    r = _ewma_closed(state.r, rres, alpha)                # [C, F]
    ang = jnp.arctan2(r.imag, r.real)
    level = jnp.abs(r)

    new_state = PilotOpenState(
        z_prev=z[:, -1], dw=dw[:, -1],
        psi=jnp.mod(psi_next + np.pi, TWO_PI) - np.pi,
        r=r[:, -1],
        base=jnp.mod(state.base + float(np.mod(wc * n, 2 * np.pi)), TWO_PI))
    # per-chunk phase-ramp params: phase(fL + t) = p0[f] + wf[f]*t.
    # +pi/2 converts "phase of e^{j psi}" to the pilot ~= A*sin(phase)
    # convention of the PLL detectors
    p0 = (state.base[:, None] + ramp_d[None, :] + psi + ang + (np.pi / 2.0))
    wf = wc + dw
    return new_state, (p0, wf, tin_d), level


def pilot_open_run(cfg: PilotOpenConfig, state: PilotOpenState,
                   raw: jax.Array, chunk: int | None = None):
    """pilot_open_core + per-sample phase materialization.

    Returns (state', phases [C, N], level [C, F]); see pilot_open_core for
    the algorithm."""
    c, n = raw.shape
    new_state, (p0, wf, tin_d), level = pilot_open_core(cfg, state, raw,
                                                        chunk)
    phases = (p0[:, :, None] + wf[:, :, None] * tin_d[None, None, :]
              ).reshape(c, n)
    return new_state, phases, level


# --------------------------------------- open-loop BPSK carrier (RDS, squared)

@pytree_dataclass
class CostasOpenConfig:
    """Scan-free BPSK carrier recovery by SQUARING (the classic squaring
    loop, blockwise): s = x^2 removes the +-1 data modulation and leaves a
    tone at twice the carrier offset; per chunk — within-chunk conj products
    measure the squared-carrier frequency (EWMA-smoothed closed form),
    integrated-deviation phase via cumsum, residual phasor EWMA — exactly
    the pilot_open recipe, but in the squared domain on a complex input.
    The carrier phase is HALF the tracked squared phase; the inherent pi
    ambiguity maps to a BPSK sign flip, which RDS's differential encoding
    absorbs (one flipped bit only where a rare cycle slip lands).

    Replaces the per-sample Costas scan (pll_run detector='costas', the
    reference's RDS PLL demod_wfm.cpp:301-317) with ZERO sequential ops, so
    the RDS tap batches over whole multi-block dispatches."""
    dev_max: float = static_field()        # rad/sample clamp (CARRIER freq)
    chunk: int = static_field(default=64)
    bw_hz: float = static_field(default=30.0)
    sample_rate: float = static_field(default=19000.0)


def make_costas_open_config(sample_rate: float, range_hz: float = 200.0,
                            bw_hz: float = 30.0, chunk: int = 64,
                            square: bool = True) -> CostasOpenConfig:
    """The chunk length bounds the UNAMBIGUOUS frequency read: the
    chunk-to-chunk conj product measures |w·ell| < pi (2w in the squared
    domain), so the default chunk shrinks until the advertised range_hz is
    actually measurable — otherwise a carrier inside the configured range
    would alias to a wrong frequency and the clip could never engage."""
    wmax = (2.0 if square else 1.0) * TWO_PI * range_hz / sample_rate
    chunk = int(chunk)
    while chunk > 1 and wmax * chunk >= 0.9 * math.pi:
        chunk //= 2
    return CostasOpenConfig(dev_max=TWO_PI * range_hz / sample_rate,
                            chunk=chunk, bw_hz=bw_hz,
                            sample_rate=float(sample_rate))


@pytree_dataclass
class CostasOpenState:
    w2: jax.Array   # [C] f32: smoothed squared-carrier freq (rad/sample)
    psi: jax.Array  # [C] f32: integrated squared-carrier phase at next sample
    r: jax.Array    # [C] complex64: smoothed residual phasor (squared domain)
    ang: jax.Array  # [C] f32: UNWRAPPED residual angle — halving an angle
    #                 with a +-pi branch cut flips the BPSK sign every time
    #                 noise crosses the cut, so the angle is tracked as a
    #                 continuous cumsum of chunk-to-chunk angle increments
    z_prev: jax.Array  # [C] complex64: previous chunk phasor (frequency is
    #                 measured between CHUNK means, whose boxcar already
    #                 attenuates modulation sidebands — a per-sample conj
    #                 product is power-weighted and an asymmetric sideband
    #                 would bias the carrier estimate toward itself)


def costas_open_init(channels: int) -> CostasOpenState:
    return CostasOpenState(w2=jnp.zeros((channels,), jnp.float32),
                           psi=jnp.zeros((channels,), jnp.float32),
                           r=jnp.zeros((channels,), jnp.complex64),
                           ang=jnp.zeros((channels,), jnp.float32),
                           z_prev=jnp.zeros((channels,), jnp.complex64))


def costas_open_run(cfg: CostasOpenConfig, state: CostasOpenState,
                    x: jax.Array, chunk: int | None = None,
                    square: bool = True):
    """Track the BPSK carrier in x [C, N] complex64.

    square=False tracks a PLAIN (unmodulated) carrier with the same
    machinery — no squaring, no phase halving: the open-loop smoother for
    any strong near-DC carrier (e.g. SAM's residual after the aim stage;
    symmetric AM scales the chunk phasor's magnitude only, so the phase
    estimate is unbiased by the modulation).

    Returns (state', phases [C, N] carrier phase, level [C, F] lock level).
    Streaming-exact for any whole-chunk blocking of the input (all smoothers
    are seeded closed forms).  Coherent demod = (x * exp(-1j*phases)).real.
    """
    c, n = x.shape
    ell = int(chunk or cfg.chunk)
    assert n % ell == 0, (n, ell)
    f = n // ell
    alpha = math.exp(-TWO_PI * cfg.bw_hz * ell / cfg.sample_rate)

    s = x * x if square else x                # squared domain (BPSK) or raw
    s3 = s.reshape(c, f, ell)
    # frequency from CHUNK-phasor conj products: the boxcar chunk mean
    # attenuates modulation sidebands before the frequency read (a
    # per-sample product is power-weighted — an asymmetric sideband pulls
    # the estimate toward itself); unambiguous while |w*ell| < pi
    zf = jnp.mean(s3, axis=-1)                            # [C, F]
    zp = jnp.concatenate([state.z_prev[:, None], zf[:, :-1]], axis=1)
    dm = zf * jnp.conj(zp)
    # the conj-product angle wraps at +-pi, so the usable clip is the
    # smaller of the configured range and the measurement's own span
    lim = min((2.0 if square else 1.0) * cfg.dev_max, math.pi / ell)
    w2m = jnp.clip(jnp.arctan2(dm.imag, dm.real) / ell, -lim, lim)
    w2 = _ewma_closed(state.w2, w2m, alpha)               # [C, F]

    cs = jnp.cumsum(w2, axis=-1)
    psi0 = state.psi[:, None] + ell * (cs - w2)           # [C, F] chunk starts
    psi_next = state.psi + ell * cs[:, -1]

    t_in = jnp.arange(ell, dtype=jnp.float32)
    ph_in = psi0[:, :, None] + w2[:, :, None] * t_in[None, None, :]
    zres = jnp.mean(s3 * jnp.exp(-1j * ph_in.astype(jnp.complex64)), axis=-1)
    r = _ewma_closed(state.r, zres, alpha)                # [C, F]
    level = jnp.abs(r)
    # CONTINUOUS residual angle: cumsum of chunk-to-chunk conj-product
    # increments, seeded by the carried unwrapped angle (r is smoothed, so
    # increments are small); a raw arctan2 would flip the halved carrier
    # phase by pi whenever noise crossed the +-pi cut
    r_prev = jnp.concatenate([state.r[:, None], r[:, :-1]], axis=1)
    dprod = r * jnp.conj(r_prev)
    dang = jnp.where(jnp.abs(r_prev) > 0,
                     jnp.arctan2(dprod.imag, dprod.real),
                     jnp.arctan2(r.imag, r.real))  # first-ever chunk: seed
    ang = state.ang[:, None] + jnp.cumsum(dang, axis=-1)  # [C, F]

    half = 0.5 if square else 1.0
    phases = half * (ph_in + ang[:, :, None]).reshape(c, n)
    # wrap psi/ang mod 4*pi: the HALVED carrier phase then wraps mod 2*pi,
    # so a wrap never flips the BPSK sign across call boundaries
    new_state = CostasOpenState(
        w2=w2[:, -1],
        psi=jnp.mod(psi_next + TWO_PI, 2.0 * TWO_PI) - TWO_PI,
        r=r[:, -1],
        ang=jnp.mod(ang[:, -1] + TWO_PI, 2.0 * TWO_PI) - TWO_PI,
        z_prev=zf[:, -1])
    return new_state, phases, level
