#!/usr/bin/env python
"""Parity vs the REFERENCE'S OWN DSP core (not a scipy golden).

tools/refharness compiles PebbleSDR's actual pebblelib/application sources
headless (Qt surface stubbed, read-only from /root/reference) into a CLI
(`refchain`) that runs recorded IQ through the reference receive chain
(application/receiver.cpp:758-1009) and writes demodulated samples.  This
module builds that harness on demand, drives it, and compares its output
against this chain's on the same IQ.

The comparison: coarse integer alignment by cross-correlation (the two
chains have different — both correct — group delays), then the same
short-LS-equalized SNR used by tools/parity_harness (absorbs fractional
delay + linear filter-design differences; what remains is genuine
algorithmic/numerical mismatch).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from tools.parity_harness import snr_db  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
HARNESS = os.path.join(HERE, "refharness")
REF = os.environ.get("PEBBLE_REF", "/root/reference")


def refchain_available() -> bool:
    return os.path.isdir(REF) and shutil.which("g++") is not None


def build_refchain() -> str | None:
    """Build (or reuse) the reference harness binary; None if unavailable."""
    if not refchain_available():
        return None
    binpath = os.path.join(HARNESS, "build", "refchain")
    r = subprocess.run(["bash", os.path.join(HARNESS, "build.sh")],
                       capture_output=True, text=True)
    if r.returncode != 0 or not os.path.isfile(binpath):
        raise RuntimeError(f"refchain build failed:\n{r.stdout}\n{r.stderr}")
    return binpath


def run_refchain(iq: np.ndarray, fs: int, mode: str, tune_hz: float,
                 lo: float, hi: float, agc: str = "off",
                 agc_thresh: int = 20, audio_rate: int = 0,
                 tmpdir: str = "/tmp", frames: int = 2048,
                 rds_out: str | None = None, nb1: bool = False,
                 nb2: bool = False, anf: bool = False,
                 iq_bal: tuple[float, float] | None = None) -> np.ndarray:
    """Run IQ through the reference chain; returns [2, N] float64 audio
    (left,right; mono modes duplicate).  audio_rate=0 emits at the
    reference's demod rate (no fractional resampler)."""
    binpath = build_refchain()
    if binpath is None:
        raise RuntimeError("reference harness unavailable")
    inp = os.path.join(tmpdir, "refchain_in.f64")
    outp = os.path.join(tmpdir, "refchain_out.f64")
    raw = np.empty(2 * len(iq), dtype=np.float64)
    raw[0::2] = iq.real
    raw[1::2] = iq.imag
    raw.tofile(inp)
    cmd = [binpath, "--mode", mode, "--rate", str(fs), "--tune", str(tune_hz),
           "--frames", str(frames), "--lo", str(lo), "--hi", str(hi),
           "--agc", agc, "--agc-thresh", str(agc_thresh),
           "--in", inp, "--out", outp]
    if audio_rate:
        cmd += ["--audio-rate", str(audio_rate)]
    if rds_out:
        cmd += ["--rds-out", rds_out]
    if nb1:
        cmd += ["--nb1", "1"]
    if nb2:
        cmd += ["--nb2", "1"]
    if anf:
        cmd += ["--anf", "1"]
    if iq_bal is not None:
        cmd += ["--iqbal-gain", str(iq_bal[0]),
                "--iqbal-phase", str(iq_bal[1])]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"refchain failed: {r.stderr}")
    out = np.fromfile(outp, dtype=np.float64)
    return np.stack([out[0::2], out[1::2]])


def align(ref: np.ndarray, got: np.ndarray, max_lag: int = 4096,
          probe: int = 65536) -> tuple[np.ndarray, np.ndarray]:
    """Integer-lag align `got` to `ref` by cross-correlation on a probe
    window, trimming both to the overlapping span."""
    n = min(len(ref), len(got))
    a = ref[:min(n, probe)].astype(np.float64)
    b = got[:min(n, probe)].astype(np.float64)
    a = a - a.mean()
    b = b - b.mean()
    corr = np.correlate(a, b, mode="full")
    lags = np.arange(-len(b) + 1, len(a))
    keep = np.abs(lags) <= max_lag
    lag = int(lags[keep][np.argmax(np.abs(corr[keep]))])
    # lag > 0: got is delayed relative to ref by `lag` samples? correlate
    # peaks at lag where ref[t] ~ got[t - lag]; shift accordingly.
    if lag >= 0:
        r, g = ref[lag:], got[:]
    else:
        r, g = ref[:], got[-lag:]
    n = min(len(r), len(g))
    return r[:n], g[:n]


def aligned_snr(ref: np.ndarray, got: np.ndarray, skip: int,
                eq_taps: int = 65) -> float:
    r, g = align(ref, got)
    return snr_db(r, g, skip=skip, eq_taps=eq_taps)
