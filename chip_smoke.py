#!/usr/bin/env python
"""Smoke run of the receive chain on one NVIDIA card.

    python chip_smoke.py          # phases 1-4, one card
    python chip_smoke.py --four   # phase 5 only: the sharded channelizer
                                  # on four cards of one host

Phases (one process holds the card; the CPU reference runs in a child
process that never opens it):

  1. card: nvidia-smi's name and power limit, JAX's device kind and count;
  2. the main path through the CLI (serve.cli.main, in-process) at the
     sizes SDR users run — 64 channels at 2.048 Msps, 32768-sample blocks,
     8 blocks per dispatch: synthetic AM, WFM stereo + RDS from a WAV
     capture written here from a seed, and 127 stations on the polyphase
     bank grid.  Each run's audio is checked (finite, non-zero, AM SNR,
     stereo separation, RDS PS name); each configuration's compile seconds,
     memory_analysis(), peak_bytes_in_use and steady-state ms/block are
     printed as SMOKE timings (not benchmark numbers);
  3. parity: the same inputs through the same batched step_many on the CPU
     (child process) vs the card — audio, S-meter, display-spectrum floor;
  4. the XLA front end alone at 64 and 256 channels: time, bytes moved as a
     share of 3.35 TB/s, beside the per-stage decimator cascade's time;
  5. (--four only) parallel.channelizer.build_sharded_step on a (channel=4)
     and a (channel=2, time=2) mesh for AM and WFM stereo vs the single-card
     Receiver.step.

The last line of standard output is {"ok": true, "device": {...}}.  With no
GPU, or when any phase fails, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

FS = 2_048_000
FRAMES = 32768
K = 8
CHANNELS = 64
FRONT_CHANNELS = (64, 256)
STATIONS = 127
SECONDS = 4.0
AM_TUNE = 250_000.0
FM_TUNE = 300_000.0
PS_NAME = "PEBBLES "
PEAK_BW = 3.35e12           # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
# device-vs-CPU parity limits: audio relative error, S-meter dB, display
# spectrum floor dB
AUDIO_REL_MAX, SMETER_DB_MAX, FLOOR_DB_MAX = 5e-3, 0.5, 1.0


class PhaseError(RuntimeError):
    pass


def check(cond, what: str):
    if not cond:
        raise PhaseError(what)


# ------------------------------------------------------------ signal helpers

def read_wav_audio(path: str) -> tuple[np.ndarray, int]:
    """int16 PCM wav -> ([channels, n] float in [-1, 1), rate)."""
    with wave.open(path, "rb") as w:
        ch, rate, n = w.getnchannels(), w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), "<i2").astype(np.float64)
    return pcm.reshape(n, ch).T / 32767.0, rate


def tone_fit(x: np.ndarray, f: float, rate: float):
    """Least-squares fit of sin/cos at f plus DC: (amplitude, residual)."""
    t = np.arange(len(x)) / rate
    a = np.stack([np.sin(2 * np.pi * f * t), np.cos(2 * np.pi * f * t),
                  np.ones(len(x))], 1)
    coef, *_ = np.linalg.lstsq(a, x, rcond=None)
    return float(np.hypot(coef[0], coef[1])), x - a @ coef


def audio_snr_db(x: np.ndarray, f: float, rate: float) -> float:
    """Tone SNR over the second half (past the DC blocker's transient),
    residual above 100 Hz only."""
    tail = x[len(x) // 2:]
    amp, res = tone_fit(tail, f, rate)
    sp = np.fft.rfft(res)
    sp[np.fft.rfftfreq(len(res), 1.0 / rate) < 100.0] = 0.0
    res = np.fft.irfft(sp, len(res))
    return float(10 * np.log10((amp ** 2 / 2) / max(np.mean(res ** 2),
                                                     1e-30)))


def fm_capture(seconds: float, seed: int) -> np.ndarray:
    """FM stereo + RDS at 20 dB SNR on FM_TUNE: left 700 Hz, right 2500 Hz."""
    from pebblesdr_tpu.core import siggen
    from pebblesdr_tpu.demod import rds

    n = int(seconds * FS)
    t = np.arange(n) / FS
    bits = rds.differential_encode(
        rds.ps_group_bits(0x54A8, PS_NAME, repeats=int(seconds * 4) + 2))
    return siggen.fm_broadcast(FS, 0.8 * np.sin(2 * np.pi * 700.0 * t),
                               0.8 * np.sin(2 * np.pi * 2500.0 * t),
                               FM_TUNE, rds_bits=bits, snr_db=20.0, seed=seed)


def bank_tunes(stations: int) -> np.ndarray:
    from pebblesdr_tpu.chain import pfb_bank
    from pebblesdr_tpu.ops import pfb

    m = pfb_bank.pick_bank_size(FS)
    centers = pfb.channel_freqs(pfb.plan(FS, m))
    return centers[(1 + np.arange(stations)) % m]


# ------------------------------------------------------------ configurations

def build(kind: str, channels: int | None = None):
    """(runner, params) for kind in am|wfm|pfb; runner.step_many(state,
    [params,] iq) is the entry point the CLI uses."""
    channels = channels or CHANNELS
    from pebblesdr_tpu.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu.demod.modes import DemodMode

    if kind == "pfb":
        return PfbBankReceiver(FS, FRAMES, bank_tunes(STATIONS),
                               mode=DemodMode.AM), None
    mode = DemodMode.AM if kind == "am" else DemodMode.FMS
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=FRAMES,
                                 channels=channels, mode=mode,
                                 rds=(kind == "wfm")))
    tunes = (AM_TUNE + 100.0 * (np.arange(channels) - channels // 2)
             if kind == "am" else FM_TUNE)
    return rx, rx.default_params(tunes)


def parity_input(kind: str) -> np.ndarray:
    """One dispatch of K blocks, made from a fixed seed: [K*N, 2C] float32
    planes for the Receiver kinds, [K*N, 2] for the bank."""
    n = K * FRAMES
    t = np.arange(n) / FS
    rng = np.random.default_rng(7)
    noise = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    if kind == "wfm":
        iq = fm_capture(K * FRAMES / FS, seed=7)
    else:
        f0 = AM_TUNE if kind == "am" else bank_tunes(STATIONS)[4]
        iq = (0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
              * np.exp(2j * np.pi * f0 * t) + noise)
    iq = iq.astype(np.complex64)
    c = 1 if kind == "pfb" else CHANNELS
    return np.concatenate(
        [np.broadcast_to(iq.real[:, None], (n, c)),
         np.broadcast_to(iq.imag[:, None], (n, c))], axis=1).astype(np.float32)


def run_dispatch(kind: str, runner, params, x):
    """One step_many dispatch from the initial state; host arrays out."""
    import jax.numpy as jnp

    state = runner.init_state()
    if kind == "pfb":
        _, out = runner.step_many(state, jnp.asarray(x))
    else:
        _, out = runner.step_many(state, params, jnp.asarray(x))
    return {"audio": np.asarray(out["audio"]),
            "spectrum": np.asarray(out["spectrum"]),
            "signal_db": np.asarray(out["smeter"]["signal_db"]),
            "snr_db": np.asarray(out["smeter"]["snr_db"])}


def cpu_reference(outdir: str) -> None:
    """Child process body: the parity inputs through the CPU chain."""
    for kind in ("am", "wfm", "pfb"):
        runner, params = build(kind)
        np.savez(os.path.join(outdir, f"{kind}.npz"),
                 **run_dispatch(kind, runner, params, parity_input(kind)))
        print(f"reference {kind} done", file=sys.stderr, flush=True)


# ------------------------------------------------------------ phases

def phase_card():
    import jax

    from pebblesdr_tpu.utils import device

    stamp = device.stamp()
    print(f"card: {stamp['card']}")
    print(f"jax: platform {stamp['platform']}, kind {stamp['device_kind']}, "
          f"count {stamp['count']}, jax {jax.__version__}")
    return stamp


def measure(kind: str):
    """Compile seconds, memory, peak bytes and steady-state ms/block of the
    configuration's step_many at full size (smoke timings)."""
    import jax
    import jax.numpy as jnp

    runner, params = build(kind)
    x = jnp.asarray(parity_input(kind))
    state = runner.init_state()
    args = (state, x) if kind == "pfb" else (state, params, x)
    t0 = time.perf_counter()
    state, out = runner.step_many(*args)
    jax.block_until_ready(out["audio"])
    compile_s = time.perf_counter() - t0
    if kind == "pfb":
        lowered = runner._step_many.lower(
            state, runner.params, jnp.asarray(runner.chan_idx), x)
    else:
        lowered = runner._step_many.lower(state, params, x)
    mem = lowered.compile().memory_analysis()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        args = (state, x) if kind == "pfb" else (state, params, x)
        state, out = runner.step_many(*args)
    jax.block_until_ready(out["audio"])
    ms_block = (time.perf_counter() - t0) / (steps * K) * 1e3
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[smoke {kind}] compile+first dispatch {compile_s:.1f} s; "
          f"steady {ms_block:.4f} ms/block (K={K}, device-resident input); "
          f"peak_bytes_in_use {peak}")
    print(f"[smoke {kind}] memory_analysis: argument "
          f"{mem.argument_size_in_bytes} output {mem.output_size_in_bytes} "
          f"temp {mem.temp_size_in_bytes} alias {mem.alias_size_in_bytes} "
          f"generated_code {mem.generated_code_size_in_bytes}")
    return runner, params


def run_cli(argv: list[str]) -> dict:
    from pebblesdr_tpu.serve import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"cli exit code {rc} for {argv}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    check(lines, f"cli printed no metrics for {argv}")
    return json.loads(lines[-1])


def phase_cli(tmp: str):
    from pebblesdr_tpu.io import wav

    common = ["--frames", str(FRAMES), "--blocks-per-dispatch", str(K),
              "--seconds", str(SECONDS), "--json"]
    # --- AM, synthetic source
    am_wav = os.path.join(tmp, "am.wav")
    m = run_cli(["--synthetic", "am", "--tune", str(AM_TUNE), "--channels",
                 str(CHANNELS), "--audio-out", am_wav] + common)
    a, rate = read_wav_audio(am_wav)
    check(np.all(np.isfinite(a)) and np.abs(a).max() > 0.01,
          "AM audio finite and non-zero")
    snr = audio_snr_db(a[0], 1000.0, rate)
    print(f"[cli am] {m['blocks']} blocks, step_ms {m['step_ms']}, "
          f"audio SNR {snr:.1f} dB (limit >= 40)")
    check(snr >= 40.0, f"AM audio SNR {snr:.1f} dB < 40")

    # --- WFM stereo + RDS from a WAV capture
    cap = os.path.join(tmp, "fm_capture.wav")
    wav.write_iq_wav(cap, fm_capture(SECONDS, seed=1), FS, fmt="i16")
    fm_wav = os.path.join(tmp, "fm.wav")
    m = run_cli(["--wav", cap, "--mode", "FMS", "--rds", "--tune",
                 str(FM_TUNE), "--channels", str(CHANNELS), "--audio-out",
                 fm_wav] + common)
    a, rate = read_wav_audio(fm_wav)
    check(a.shape[0] == 2 and np.all(np.isfinite(a))
          and np.abs(a).max() > 0.01, "WFM stereo audio finite, non-zero")
    half = a.shape[1] // 2
    l700, _ = tone_fit(a[0, half:], 700.0, rate)
    r700, _ = tone_fit(a[1, half:], 700.0, rate)
    r2500, _ = tone_fit(a[1, half:], 2500.0, rate)
    l2500, _ = tone_fit(a[0, half:], 2500.0, rate)
    sep = min(20 * np.log10(l700 / max(r700, 1e-12)),
              20 * np.log10(r2500 / max(l2500, 1e-12)))
    ps = m.get("rds", {}).get("ps")
    print(f"[cli wfm] {m['blocks']} blocks, step_ms {m['step_ms']}, "
          f"stereo separation {sep:.1f} dB (limit >= 30), RDS PS {ps!r} "
          f"(blocks ok {m['rds']['blocks_ok']}, errors "
          f"{m['rds']['block_errors']})")
    check(sep >= 30.0, f"stereo separation {sep:.1f} dB < 30")
    check(ps == PS_NAME, f"RDS PS {ps!r} != {PS_NAME!r}")

    # --- STATIONS offsets on the polyphase bank grid; one carries AM
    tunes = bank_tunes(STATIONS)
    st_wav = os.path.join(tmp, "st.wav")
    m = run_cli(["--synthetic", "am", "--tune", str(tunes[4]), "--stations",
                 ",".join(f"{f:.1f}" for f in tunes), "--audio-out",
                 st_wav] + common)
    rows = m["rows"]
    check(len(rows) == STATIONS, f"{STATIONS} station rows")
    check(all(np.isfinite(r["snr_db"]) for r in rows), "finite S-meter")
    a, rate = read_wav_audio(os.path.join(tmp, "st.st4.wav"))
    check(np.all(np.isfinite(a)) and np.abs(a).max() > 0.01,
          "station audio finite and non-zero")
    snr = audio_snr_db(a[0], 1000.0, rate)
    print(f"[cli stations] {m['blocks']} blocks, bank {m['bank']}, step_ms "
          f"{m['step_ms']}, station 4 audio SNR {snr:.1f} dB (limit >= 40)")
    check(snr >= 40.0, f"station audio SNR {snr:.1f} dB < 40")


def phase_parity(ref_dir: str, child, results: dict):
    from pebblesdr_tpu.core.precision import DOT_PRECISION

    try:
        child.wait(timeout=900)
    except subprocess.TimeoutExpired:
        child.kill()
        raise PhaseError("CPU reference child timed out")
    check(child.returncode == 0, f"CPU reference exit {child.returncode}")
    for kind, got in results.items():
        ref = np.load(os.path.join(ref_dir, f"{kind}.npz"))
        d_audio = (np.abs(got["audio"] - ref["audio"]).max()
                   / max(np.abs(ref["audio"]).max(), 1e-12))
        d_sm = max(np.abs(got[k] - ref[k]).max()
                   for k in ("signal_db", "snr_db"))
        floor = lambda s: np.percentile(s, 10, axis=-1)  # noqa: E731
        d_floor = np.abs(floor(got["spectrum"]) - floor(ref["spectrum"])).max()
        print(f"[parity {kind}] precision {DOT_PRECISION}: audio rel "
              f"{d_audio:.3e} (< {AUDIO_REL_MAX}), S-meter |d| {d_sm:.4f} dB "
              f"(< {SMETER_DB_MAX}), spectrum floor |d| {d_floor:.4f} dB "
              f"(< {FLOOR_DB_MAX})")
        check(d_audio < AUDIO_REL_MAX and d_sm < SMETER_DB_MAX
              and d_floor < FLOOR_DB_MAX, f"parity {kind}")


def phase_front(card: str):
    import jax
    import jax.numpy as jnp

    from pebblesdr_tpu.ops import decimator, front, iir

    for channels in FRONT_CHANNELS:
        rx, params = build("am", channels)
        n = K * FRAMES
        rng = np.random.default_rng(3)
        x = jnp.asarray((rng.standard_normal((channels, n))
                         + 1j * rng.standard_normal((channels, n))
                         ).astype(np.complex64))
        fused = jax.jit(lambda st, p, x: rx._front(st, p, x)[:2])
        plan = rx.plan

        def cascade(st, p, x):
            dc, y = iir.dc_removal_chunked(st.dc, x, alpha=front.DC_ALPHA)
            ph, y = front.mix_blocks(st.mixer.phase, y, p.tune_hi, p.tune_lo,
                                     FRAMES)
            return decimator.apply(plan, decimator.state_init(plan, channels),
                                   y)

        staged = jax.jit(cascade)
        st = rx.init_state()
        times = {}
        for name, fn in (("composed", fused), ("cascade", staged)):
            jax.block_until_ready(fn(st, params, x))
            reps = 20
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(st, params, x)
            jax.block_until_ready(out)
            times[name] = (time.perf_counter() - t0) / reps
        nbytes = channels * n * 8 * (1 + 1 / plan.factor)
        share = nbytes / times["composed"] / PEAK_BW
        print(f"[front {channels}ch x {n}] XLA composed front "
              f"{times['composed'] * 1e3:.3f} ms/dispatch "
              f"({times['composed'] / K * 1e3:.4f} ms/block), "
              f"{nbytes / 1e6:.1f} MB -> {nbytes / times['composed'] / 1e9:.0f}"
              f" GB/s = {share:.3f} of 3.35 TB/s [{card}]; per-stage cascade "
              f"(mix + decimator.apply) {times['cascade'] * 1e3:.3f} "
              f"ms/dispatch")


def phase_four():
    import jax
    import jax.numpy as jnp

    from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu.demod.modes import DemodMode
    from pebblesdr_tpu.parallel import channelizer, mesh as mesh_mod

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, have "
          f"{len(jax.devices())}")
    t = np.arange(2 * FRAMES) / FS
    am = (0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
          * np.exp(2j * np.pi * AM_TUNE * t))
    fm = fm_capture(2 * FRAMES / FS, seed=4)
    for mode, cap, tune in ((DemodMode.AM, am, AM_TUNE),
                            (DemodMode.FMS, fm, FM_TUNE)):
        rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=FRAMES,
                                     channels=CHANNELS, mode=mode))
        tunes = tune + 100.0 * (np.arange(CHANNELS) - CHANNELS // 2)
        params = rx.default_params(tunes)
        iq = np.broadcast_to(cap.astype(np.complex64), (CHANNELS, 2 * FRAMES))
        blocks = [np.ascontiguousarray(iq[:, i * FRAMES:(i + 1) * FRAMES])
                  for i in range(2)]
        st = rx.init_state()
        for b in blocks:
            st, out = rx.step(st, params, jnp.asarray(b), spectra=False)
        ref = np.asarray(out["audio"])
        for shape in ({"channel": 4, "time": 1}, {"channel": 2, "time": 2}):
            m = mesh_mod.make_mesh(**shape)
            step = channelizer.build_sharded_step(rx, m)
            st_sh = mesh_mod.shard_state(rx.init_state(), m)
            for b in blocks:
                blk = jax.device_put(jnp.asarray(b),
                                     mesh_mod.block_sharding(m))
                st_sh, audio = step(st_sh, params, blk)
            devs = {d.id for d in audio.sharding.device_set}
            dev = (np.abs(np.asarray(audio) - ref).max()
                   / max(np.abs(ref).max(), 1e-12))
            print(f"[four {mode.name} {shape}] sharded vs single-card "
                  f"rel {dev:.3e} (<= 2e-3), audio on devices {sorted(devs)}")
            check(dev <= 2e-3, f"sharded {mode.name} {shape} parity")
            check(len(devs) == 4, "output on four distinct devices")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded channelizer phase")
    ap.add_argument("--reference", metavar="DIR",
                    help=argparse.SUPPRESS)  # the CPU child's entry
    args = ap.parse_args(argv)

    if args.reference:
        cpu_reference(args.reference)
        return 0

    import jax

    from pebblesdr_tpu.utils import compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 2
    compile_cache.enable()
    stamp = phase_card()
    if args.four:
        phase_four()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       CUDA_VISIBLE_DEVICES="")
            child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--reference",
                 tmp], env=env)
            try:
                results = {}
                for kind in ("am", "wfm", "pfb"):
                    runner, params = measure(kind)
                    results[kind] = run_dispatch(kind, runner, params,
                                                 parity_input(kind))
                phase_cli(tmp)
                phase_parity(tmp, child, results)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        phase_front(stamp["card"])
    print(f"card: {stamp['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": stamp["platform"], "kind": stamp["device_kind"],
        "count": stamp["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke.py: phase failed: {e}", file=sys.stderr)
        sys.exit(1)
