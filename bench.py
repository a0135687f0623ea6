#!/usr/bin/env python
"""Headline benchmark: IQ Msamples/s/chip through the full filter+demod chain.

Default run measures the MATRIX: AM 64ch (headline), WFM-stereo 64ch, SAM
64ch, AM 16ch/256ch (channel scaling), and the PFB dense-bank front end at
127 stations, all in the one parsed JSON line (headline fields = the AM row;
the rest under "matrix").  Every row runs in its own child process (one
process per card; the parent never imports JAX), refuses to time on a CPU,
and carries the device stamp (platform, device_kind, count, the card's name
and power limit).

Baseline: the reference's measured whole-chain time of 7.035 ms per
2048-sample block (application/receiver.cpp:780-785) = 0.291 Msamples/s on a
single channel; vs_baseline is the speedup of our per-chip aggregate
throughput over that number.

Env knobs: BENCH_MODE=matrix|am|wfm|sam|pfb|quality|ab (BENCH_AB=a,b paired), BENCH_CHANNELS, BENCH_BLOCKS,
BENCH_STEPS, BENCH_FRAMES, BENCH_AGC_STRIDE, BENCH_SPECTRA_EVERY.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "matrix"}.
"""

import json
import os
import sys
import time

import numpy as np

CHANNELS = int(os.environ.get("BENCH_CHANNELS", "64"))
FRAMES = int(os.environ.get("BENCH_FRAMES", "32768"))
FS = int(os.environ.get("BENCH_FS", "2048000"))
WARMUP = 3
STEPS = int(os.environ.get("BENCH_STEPS", "40"))
# blocks per dispatch (Receiver.step_many): amortizes the per-dispatch
# launch cost across K blocks
BLOCKS = int(os.environ.get("BENCH_BLOCKS", "32"))
MODE = os.environ.get("BENCH_MODE", "matrix")  # matrix | am | wfm | sam | pfb
REFERENCE_MSPS = 2048.0 / 7.035e-3 / 1e6  # 0.291 Msps (receiver.cpp:780-785)


def _synth_iq(mode_name: str, frames: int) -> np.ndarray:
    t = np.arange(frames) / FS
    if mode_name.startswith("wfm"):
        comp = (0.45 * np.sin(2 * np.pi * 1000.0 * t)
                + 0.1 * np.sin(2 * np.pi * 19000.0 * t))
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        return (0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + phase))
                ).astype(np.complex64)
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    return (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)).astype(np.complex64)


def _timed_windows(run_once, sync_out, steps: int):
    """3 independent windows of `steps` dispatches, each ending in
    block_until_ready; returns (min, all windows)."""
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for i in range(steps):
            out = run_once(i)
        sync_out(out)
        dts.append(time.perf_counter() - t0)
    return min(dts), dts


def _build_runner(mode_name: str, channels: int, blocks: int,
                  frames: int = FRAMES):
    """Build one config's compiled runner: returns (run_once(i)->out,
    sync(out), box, compile_s).  Shared by bench_receiver and the paired-A/B
    mode."""
    import jax
    import jax.numpy as jnp

    from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu.demod.modes import DemodMode

    mode = {"wfm": DemodMode.FMS, "wfm_rds": DemodMode.FMS,
            "wfm_hq": DemodMode.FMS, "sam": DemodMode.SAM}.get(
        mode_name, DemodMode.AM)
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=frames,
                         channels=channels, mode=mode,
                         rds=(mode_name == "wfm_rds"),
                         wfm_hq=(mode_name == "wfm_hq"),
                         enable_noise_blanker=(mode_name == "am_nb"),
                         agc_stride=int(os.environ.get("BENCH_AGC_STRIDE", "16")))
    rx = Receiver(cfg)
    state = jax.jit(lambda: rx.init_state())()
    params = rx.default_params(250_000.0)
    iq = _synth_iq(mode_name, frames)
    plane = np.concatenate([
        np.broadcast_to(iq.real.astype(np.float32)[:, None], (frames, channels)),
        np.broadcast_to(iq.imag.astype(np.float32)[:, None], (frames, channels)),
    ], axis=1)
    if os.environ.get("BENCH_I16") or mode_name.endswith("_i16"):
        # i16 entry planes (native-ADC container, dequantized on the
        # device): half the input bytes of the f32 plane
        plane = np.clip(np.round(plane * 32768.0), -32768,
                        32767).astype(np.int16)

    import functools

    @functools.partial(jax.jit, static_argnames=("spectra",))
    def step(state, params, iq_ri, spectra=True):
        return rx._step_many_impl(state, params, iq_ri, spectra=spectra)

    # display-spectra cadence: the reference computes display FFTs at
    # updatesPerSecond (10/s; signalspectrum.cpp:63-86), NOT per block —
    # with 16 ms blocks that is every ~6th block.  The S-meter/squelch
    # power (the zoomed transform) still runs EVERY block.
    spectra_every = int(os.environ.get("BENCH_SPECTRA_EVERY", "6"))

    def sync(o):
        jax.block_until_ready(o["audio"])

    # one block shipped and tiled on the device: host->device transfer is
    # not part of these rows
    iq_dev = jax.jit(lambda b: jnp.tile(b, (blocks, 1)))(jnp.asarray(plane))

    t_c = time.perf_counter()
    st = state
    out = None
    for i in range(WARMUP):
        st, out = step(st, params, iq_dev, spectra=(i % spectra_every == 0))
    sync(out)
    compile_s = time.perf_counter() - t_c
    print(f"# [{mode_name} {channels}ch] compile+warmup {compile_s:.1f}s",
          file=sys.stderr)

    box = {"st": st}

    def run_once(i):
        box["st"], out = step(box["st"], params, iq_dev,
                              spectra=(i % spectra_every == 0))
        return out

    return run_once, sync, box, compile_s


def bench_receiver(mode_name: str, channels: int, blocks: int, steps: int,
                   frames: int = FRAMES) -> dict:
    """One Receiver config.  Returns the row dict."""
    run_once, sync_audio, _box, compile_s = _build_runner(
        mode_name, channels, blocks, frames)
    dt, dts = _timed_windows(run_once, sync_audio, steps)
    samples = channels * frames * blocks * steps
    msps = samples / dt / 1e6
    per_chan = samples / channels / dt
    print(f"# [{mode_name} {channels}ch] windows "
          f"{['%.2fs' % d for d in dts]}; block "
          f"{dt/(steps*blocks)*1e3:.3f} ms", file=sys.stderr)
    return {
        "config": f"{mode_name}_{channels}ch",
        "msps_per_chip": round(msps, 1),
        "realtime_per_channel": round(per_chan / FS, 1),
        "block_ms": round(dt / (steps * blocks) * 1e3, 3),
        "compile_warmup_s": round(compile_s, 1),
        "windows_s": [round(d, 3) for d in dts],
        "window_spread": round(max(dts) / max(min(dts), 1e-9), 2),
        "vs_baseline": round(msps / REFERENCE_MSPS, 1),
    }


def bench_ab(mode_a: str, mode_b: str, channels: int, blocks: int,
             steps: int, frames: int = FRAMES) -> dict:
    """Paired A/B on ADJACENT dispatches: both configs compiled in ONE
    process on one card, measurement windows interleaved A,B,A,B,... so each
    pair shares the card's clock and power state; the reported ratio's
    spread is the uncertainty of a row-vs-row comparison."""
    run_a, sync_a, _ba, _ca = _build_runner(mode_a, channels, blocks, frames)
    run_b, sync_b, _bb, _cb = _build_runner(mode_b, channels, blocks, frames)
    pairs = []
    win_steps = max(8, steps // 4)
    for _ in range(4):
        t0 = time.perf_counter()
        out = None
        for i in range(win_steps):
            out = run_a(i)
        sync_a(out)
        ta = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(win_steps):
            out = run_b(i)
        sync_b(out)
        tb = time.perf_counter() - t0
        pairs.append((ta, tb))
    ratios = [tb / ta for ta, tb in pairs]
    samples = channels * frames * blocks * win_steps
    return {
        "config": f"ab_{mode_a}_vs_{mode_b}_{channels}ch",
        "a_msps": round(samples / min(p[0] for p in pairs) / 1e6, 1),
        "b_msps": round(samples / min(p[1] for p in pairs) / 1e6, 1),
        "b_over_a_ratio": round(float(np.median(ratios)), 4),
        "ratio_spread": round(max(ratios) / min(ratios), 3),
        "pairs_s": [[round(a, 3), round(b, 3)] for a, b in pairs],
    }


def bench_pfb(stations: int, blocks: int, steps: int,
              frames: int = FRAMES) -> dict:
    """PFB dense-bank front end: ONE wideband capture -> `stations` AM
    channels through the shared filterbank (front cost sublinear in C)."""
    import jax
    import jax.numpy as jnp

    from pebblesdr_tpu.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu.demod.modes import DemodMode
    from pebblesdr_tpu.ops import pfb as pfb_mod

    m = int(os.environ.get("BENCH_PFB_BANK", "128"))
    plan = pfb_mod.plan(FS, m)
    centers = pfb_mod.channel_freqs(plan)
    # stations on distinct grid centers (skip channel 0 = DC)
    idx = (1 + np.arange(stations)) % m
    tunes = centers[idx]
    # apples-to-apples with the am rows (VERDICT r2 weak 5): AGC on (the
    # am rows' default "med" with the same stride) and spectra computed
    # every step
    bank = PfbBankReceiver(
        FS, frames, tunes, mode=DemodMode.AM, n_bank=m,
        agc_stride=int(os.environ.get("BENCH_AGC_STRIDE", "16")))
    state = jax.jit(bank.init_state)()
    iq = _synth_iq("am", frames)
    plane = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    big = jax.jit(lambda b: jnp.tile(b, (blocks, 1)))(jnp.asarray(plane))

    t_c = time.perf_counter()
    st = state
    out = None
    for _ in range(WARMUP):
        st, out = bank.step_many(st, big, spectra=True)
    jax.block_until_ready(out["audio"])
    compile_s = time.perf_counter() - t_c
    print(f"# [pfb {stations}st bank{m}] compile+warmup {compile_s:.1f}s",
          file=sys.stderr)

    box = {"st": st}

    def run_once(i):
        box["st"], out = bank.step_many(box["st"], big, spectra=True)
        return out

    dt, dts = _timed_windows(run_once,
                             lambda o: jax.block_until_ready(o["audio"]),
                             steps)
    # delivered work = every station demodulates the full-rate stream
    samples = stations * frames * blocks * steps
    msps = samples / dt / 1e6
    print(f"# [pfb] windows {['%.2fs' % d for d in dts]}; block "
          f"{dt/(steps*blocks)*1e3:.3f} ms", file=sys.stderr)
    return {
        "config": f"pfb_{stations}st_bank{m}",
        "msps_per_chip": round(msps, 1),
        "realtime_per_channel": round(samples / stations / dt / FS, 1),
        "block_ms": round(dt / (steps * blocks) * 1e3, 3),
        "compile_warmup_s": round(compile_s, 1),
        "windows_s": [round(d, 3) for d in dts],
        "window_spread": round(max(dts) / max(min(dts), 1e-9), 2),
        "vs_baseline": round(msps / REFERENCE_MSPS, 1),
    }


def bench_quality() -> dict:
    """Measured QUALITY alongside the speed rows: stereo separation at the
    default (256k Carson) and hq (>=400k reference) geometries, plus RDS
    block-error rate + PS decode at 20 dB IQ SNR with a 4 Hz carrier offset.
    Runs on the card like every row: a precision fault in a device kernel
    shows here first."""
    import jax.numpy as jnp

    from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu.demod import rds as rds_mod
    from pebblesdr_tpu.demod.modes import DemodMode

    frames, kb = 32768, 20
    t = np.arange(kb * frames) / FS

    def tone_amp(audio, f_tone, rate):
        n = len(audio)
        tt = np.arange(n) / rate
        a = np.stack([np.sin(2 * np.pi * f_tone * tt),
                      np.cos(2 * np.pi * f_tone * tt), np.ones(n)], 1)
        coef, *_ = np.linalg.lstsq(a, audio, rcond=None)
        return float(np.hypot(coef[0], coef[1]))

    row = {"config": "quality"}
    # --- stereo separation: L-only 700 Hz program ---
    lt = np.sin(2 * np.pi * 700.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
          ).astype(np.complex64)
    for name, hq in (("stereo_sep_db", False), ("stereo_sep_hq_db", True)):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=frames,
                             channels=1, mode=DemodMode.FMS, wfm_hq=hq)
        rx = Receiver(cfg)
        st = rx.init_state()
        params = rx.default_params(250_000.0)
        outs = []
        for i in range(kb):
            st, out = rx.step(st, params,
                              jnp.asarray(iq[None, i * frames:(i + 1) * frames]),
                              spectra=False)
            outs.append(np.asarray(out["audio"]))
        aud = np.concatenate(outs, -1)[0]
        half = aud.shape[-1] // 2
        al = tone_amp(aud[0, half:], 700.0, cfg.audio_rate)
        ar = tone_amp(aud[1, half:], 700.0, cfg.audio_rate)
        row[name] = round(20 * np.log10(al / max(ar, 1e-12)), 1)
    # --- RDS at 20 dB SNR + 4 Hz offset (the noisy-chain shape) ---
    bits = rds_mod.ps_group_bits(0x54A8, "PEBBLES ", repeats=24)
    sym = np.asarray(rds_mod.differential_encode(bits), np.float64) * 2 - 1
    nb2 = 40
    t2 = np.arange(nb2 * frames) / FS
    sym_idx = np.minimum((t2 * rds_mod.RDS_BAUD).astype(np.int64),
                         len(sym) - 1)
    frac = t2 * rds_mod.RDS_BAUD - sym_idx
    biphase = sym[sym_idx] * np.where(frac < 0.5, 1.0, -1.0)
    comp2 = (0.3 * np.sin(2 * np.pi * 1000.0 * t2)
             + 0.1 * np.sin(2 * np.pi * 19000.0 * t2)
             + 0.06 * biphase * np.cos(2 * np.pi * 57000.0 * t2))
    ph2 = 2 * np.pi * np.cumsum(75000.0 * comp2) / FS
    carrier = 0.5 * np.exp(1j * (2 * np.pi * 300_004.0 * t2 + ph2))
    rng = np.random.default_rng(11)
    sigma = np.sqrt(0.25 / 10 ** (20.0 / 10) / 2)
    iq2 = (carrier + sigma * (rng.normal(size=len(t2))
                              + 1j * rng.normal(size=len(t2)))
           ).astype(np.complex64)
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=frames,
                         channels=1, mode=DemodMode.FMS, rds=True)
    rx = Receiver(cfg)
    st = rx.init_state()
    params = rx.default_params(300_000.0)
    dec = rds_mod.RdsBlockDecoder()
    for i in range(nb2):
        st, out = rx.step(st, params,
                          jnp.asarray(iq2[None, i * frames:(i + 1) * frames]),
                          spectra=False)
        dec.feed_symbols(np.asarray(out["rds_soft"])[0])
    total = dec.blocks_ok + dec.block_errors
    g = rds_mod.RdsGroupDecoder()
    for grp in dec.groups:
        g.decode(grp)
    row["rds_bler_20db"] = round(dec.block_errors / max(1, total), 3)
    row["rds_ps_decoded"] = (g.ps_name == "PEBBLES ")
    row["rds_snr_db"] = 20.0

    # --- RDS BLER vs SNR curve (VERDICT r4 item 8: not one point) ---------
    for snr_pt in (14.0, 17.0):
        sigma_p = np.sqrt(0.25 / 10 ** (snr_pt / 10) / 2)
        rng_p = np.random.default_rng(11)
        iq_p = (carrier + sigma_p * (rng_p.normal(size=len(t2))
                                     + 1j * rng_p.normal(size=len(t2)))
                ).astype(np.complex64)
        st_p = rx.init_state()
        dec_p = rds_mod.RdsBlockDecoder()
        for i in range(nb2):
            st_p, out = rx.step(
                st_p, params,
                jnp.asarray(iq_p[None, i * frames:(i + 1) * frames]),
                spectra=False)
            dec_p.feed_symbols(np.asarray(out["rds_soft"])[0])
        tot_p = dec_p.blocks_ok + dec_p.block_errors
        row[f"rds_bler_{int(snr_pt)}db"] = round(
            dec_p.block_errors / max(1, tot_p), 3)

    # --- impairment metrics (VERDICT r4 item 8; TestBench-spirit:
    # testbench.cpp:518-542 gen + nco.cpp CW) — stereo separation under
    # two-ray multipath, AM audio SNR under an adjacent-channel station
    # and a -50 dB in-band CW spur ---------------------------------------
    kb_i = 16
    ti = t[:kb_i * frames]

    def run_chain_audio(sig, mode, tune, agc="off"):
        cfg_i = ReceiverConfig(sample_rate=FS, frames_per_buffer=frames,
                               channels=1, mode=mode, agc_mode=agc)
        rx_i = Receiver(cfg_i)
        st_i = rx_i.init_state()
        p_i = rx_i.default_params(tune)
        outs = []
        for i in range(kb_i):
            st_i, o = rx_i.step(
                st_i, p_i,
                jnp.asarray(sig[None, i * frames:(i + 1) * frames]),
                spectra=False)
            outs.append(np.asarray(o["audio"]))
        return np.concatenate(outs, -1)[0], cfg_i.audio_rate

    # stereo separation through a 15 us / -10 dB two-ray channel
    lt_i = np.sin(2 * np.pi * 700.0 * ti)
    th_i = 2 * np.pi * 19000.0 * ti
    comp_i = (0.45 * lt_i + 0.1 * np.sin(th_i)
              + 0.45 * lt_i * np.sin(2 * th_i))
    ph_i = 2 * np.pi * np.cumsum(75000.0 * comp_i) / FS
    iq_w = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * ti + ph_i))
    d_mp = int(15e-6 * FS)
    echo = (np.concatenate([np.zeros(d_mp, complex), iq_w[:-d_mp]])
            * 10 ** (-10 / 20) * np.exp(1j * 2.1))
    aud, ar_w = run_chain_audio((iq_w + echo).astype(np.complex64),
                                DemodMode.FMS, 250_000.0)
    half = aud.shape[-1] // 2
    al = tone_amp(aud[0, half:], 700.0, ar_w)
    ar_ = tone_amp(aud[1, half:], 700.0, ar_w)
    row["stereo_sep_multipath_db"] = round(
        20 * np.log10(al / max(ar_, 1e-12)), 1)

    def am_audio_snr(sig):
        aud_a, ar_a = run_chain_audio(sig.astype(np.complex64),
                                      DemodMode.AM, 250_000.0)
        tail = aud_a[len(aud_a) // 2:]
        tt = np.arange(len(tail)) / ar_a
        a = np.stack([np.sin(2 * np.pi * 1000 * tt),
                      np.cos(2 * np.pi * 1000 * tt), np.ones(len(tail))], 1)
        coef, *_ = np.linalg.lstsq(a, tail, rcond=None)
        amp = np.hypot(coef[0], coef[1])
        resid = tail - a @ coef
        sp = np.fft.rfft(resid)
        fr_ = np.fft.rfftfreq(len(resid), 1 / ar_a)
        sp[fr_ < 150] = 0
        res = np.fft.irfft(sp, len(resid))
        return 10 * np.log10((amp ** 2 / 2) / np.mean(res ** 2))

    env_i = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * ti)) / 2
    base_am = 0.5 * env_i * np.exp(2j * np.pi * 250_000.0 * ti)
    snr_clean = am_audio_snr(base_am)
    nb_env = (1 + 0.8 * np.cos(2 * np.pi * 700.0 * ti)) / 2
    adj = 0.05 * nb_env * np.exp(2j * np.pi * 280_000.0 * ti)
    cw = 10 ** (-50 / 20) * 0.5 * np.exp(2j * np.pi * 252_500.0 * ti)
    row["am_audio_snr_db"] = round(snr_clean, 1)
    row["am_adj_channel_snr_delta_db"] = round(
        snr_clean - am_audio_snr(base_am + adj), 2)
    row["am_cw50_snr_delta_db"] = round(
        snr_clean - am_audio_snr(base_am + cw), 2)

    # --- AGC: parallel (windowed-max hang) vs sample-exact scan on a
    # steady-carrier dropout (the hang-defining fixture; VERDICT r3 item 7):
    # max 25 ms RMS envelope delta after convergence, in dB
    from pebblesdr_tpu.ops import agc as agc_mod
    fs_a = 8000.0
    n_a = int(fs_a * 4.5)
    ta = np.arange(n_a) / fs_a
    env = np.ones(n_a)
    env[int(3.5 * fs_a):int(4.0 * fs_a)] = 0.01
    rng_a = np.random.default_rng(5)
    xa = ((env * np.exp(2j * np.pi * 500.0 * ta)
           + 2e-3 * (rng_a.standard_normal(n_a)
                     + 1j * rng_a.standard_normal(n_a)))
          .astype(np.complex64))[None]
    xa = xa[:, :(n_a // 2048) * 2048]
    outs_a = {}
    for alg in ("parallel", "scan"):
        cfg_a = agc_mod.AGCConfig.make(fs_a, mode="long", threshold_db=-40.0,
                                       algorithm=alg)
        st_a = agc_mod.agc_init(cfg_a, 1)
        ys = []
        for k in range(xa.shape[-1] // 2048):
            st_a, y = agc_mod.agc_apply(cfg_a, st_a,
                                        jnp.asarray(xa[:, k*2048:(k+1)*2048]))
            ys.append(np.asarray(y)[0])
        outs_a[alg] = np.concatenate(ys)
    seg = int(0.025 * fs_a)
    n_seg = len(outs_a["scan"]) // seg
    rms = {a: np.sqrt(np.mean(np.abs(v[:n_seg * seg].reshape(n_seg, seg))
                              ** 2, axis=1)) for a, v in outs_a.items()}
    d_db = 20 * np.log10((rms["parallel"] + 1e-9) / (rms["scan"] + 1e-9))
    row["agc_hang_par_vs_scan_db"] = round(float(np.max(np.abs(d_db[8:]))), 2)
    return row


def run_one(mode: str) -> dict:
    """One configuration in THIS process (BENCH_MODE=<row> path), stamped
    with the device it ran on.  Refuses to time anything but a card."""
    from pebblesdr_tpu.utils import compile_cache, device

    compile_cache.enable()
    stamp = device.stamp()
    if stamp["platform"] == "cpu":
        raise SystemExit("bench.py times the accelerator, and JAX found "
                         "none (platform cpu); run it on the card")
    if mode == "pfb":
        row = bench_pfb(int(os.environ.get("BENCH_PFB_STATIONS", "127")),
                        BLOCKS, STEPS)
    elif mode == "quality":
        row = bench_quality()
    elif mode == "ab":
        a, b = os.environ.get("BENCH_AB", "am,am_i16").split(",")
        row = bench_ab(a.strip(), b.strip(), CHANNELS, BLOCKS, STEPS)
    else:
        row = bench_receiver(mode, CHANNELS, BLOCKS, STEPS)
    return {**row, "device": stamp}


def _row_subprocess(mode: str, channels=None, blocks=None, steps=None):
    """Run one matrix row in its own child process (one JAX process per
    card; the parent never imports JAX)."""
    import subprocess

    env = dict(os.environ, BENCH_MODE=mode)
    if channels is not None:
        env["BENCH_CHANNELS"] = str(channels)
    if blocks is not None:
        env["BENCH_BLOCKS"] = str(blocks)
    if steps is not None:
        env["BENCH_STEPS"] = str(steps)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__)],
                          env=env, capture_output=True, text=True)
    sys.stderr.write(proc.stderr)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            return d["matrix"][0] if "matrix" in d else d
    return {"config": mode, "error": f"exit code {proc.returncode}"}


def main():
    t_all = time.perf_counter()
    if MODE == "matrix":
        # headline row gets 2x steps: a fixed fill/drain cost per timed
        # window biases short windows high
        rows = [_row_subprocess("am", CHANNELS, BLOCKS, 2 * STEPS)]
        # WFM batches like AM (scan-free open pilot)
        rows.append(_row_subprocess("wfm", CHANNELS, BLOCKS, STEPS))
        # the flagship BASELINE config #2 shape: stereo + RDS decode, on the
        # batched fast path (scan-free squaring-loop RDS carrier)
        rows.append(_row_subprocess("wfm_rds", CHANNELS, BLOCKS, STEPS))
        # reference-parity quality geometry (512k discrimination, composite
        # decimated to the tuned 256k tail) — full dispatch geometry like
        # the other WFM rows now that the tail no longer doubles the memory
        rows.append(_row_subprocess("wfm_hq", CHANNELS, BLOCKS, STEPS))
        # SAM is scan-free now (open-loop stage-2 smoother): full
        # blocks/dispatch amortizes the fixed cost like the other rows
        rows.append(_row_subprocess("sam", CHANNELS, BLOCKS, STEPS))
        # channel-count scaling: 256ch (the "many concurrent wideband
        # channels" shape) and 16ch (2x blocks per dispatch: less work per
        # dispatch)
        rows.append(_row_subprocess("am", 256, max(8, BLOCKS // 2),
                                    max(16, STEPS // 2)))
        # same shape with int16 entry planes (native-ADC container,
        # dequantized on the device): half the entry bytes
        rows.append(_row_subprocess("am_i16", 256, max(8, BLOCKS // 2),
                                    max(16, STEPS // 2)))
        # full steps on the 16ch rows: the fixed fill/drain per window
        # biases short-window numbers high
        rows.append(_row_subprocess("am", 16, 2 * BLOCKS, STEPS))
        rows.append(_row_subprocess("wfm", 16, 2 * BLOCKS, STEPS))
        # NB-on flagship (noise blanker in the front end); full steps so the
        # fill/drain bias matches the NB-off row it is compared against
        rows.append(_row_subprocess("am_nb", CHANNELS, BLOCKS, STEPS))
        # batched bank tail: one straight-line graph per dispatch
        rows.append(_row_subprocess("pfb", blocks=2 * BLOCKS,
                                    steps=max(16, STEPS // 2)))
        # measured quality (stereo separation, RDS BLER), on the card
        rows.append(_row_subprocess("quality"))
        ok = [r for r in rows if "msps_per_chip" in r]
        head = ok[0] if ok else {"config": "none", "msps_per_chip": 0.0,
                                 "vs_baseline": 0.0}
    else:
        head = run_one(MODE)
        rows = [head]
    total_s = time.perf_counter() - t_all

    result = {
        "metric": "iq_msps_per_chip",
        "value": head.get("msps_per_chip", 0.0),
        "unit": "Msamples/s/chip (full %s chain)" % head["config"],
        "vs_baseline": head.get("vs_baseline", 0.0),
        "matrix": rows,
        "total_bench_s": round(total_s, 1),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
