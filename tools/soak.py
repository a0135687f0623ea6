#!/usr/bin/env python
"""Sustained-stream soak: the flagship WFM-stereo + RDS config at 64
channels, carried state across every dispatch, host RDS decode running —
watches for NaNs, pilot-lock dropouts, RDS sync loss, and drift.

SOAK_SECONDS (default 120) of wall clock; prints one JSON line.

Note on rds_bler: the fixture LOOPS every dispatch (0.512 s) and 104-bit
groups don't divide the loop, so every seam corrupts 1-2 blocks and forces
a resync — the reported BLER is dominated by that deliberate adversity.
The soak's pass criteria are zero bad dispatches (NaN/lock), sync held,
and the PS name decoded continuously."""

import json
import os
import sys
import time

import numpy as np

SECONDS = float(os.environ.get("SOAK_SECONDS", "120"))
C = int(os.environ.get("SOAK_CHANNELS", "64"))
K = int(os.environ.get("SOAK_BLOCKS", "32"))
N = 32768
FS = 2_048_000


def main():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from pebblesdr_tpu.utils import compile_cache

    compile_cache.enable()
    from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu.demod import rds as rds_mod
    from pebblesdr_tpu.demod.modes import DemodMode

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=C,
                         mode=DemodMode.FMS, rds=True, agc_stride=16,
                         wfm_hq=bool(int(os.environ.get("SOAK_HQ", "0"))))
    rx = Receiver(cfg)
    state = jax.jit(lambda: rx.init_state())()
    params = rx.default_params(250_000.0)

    # K-block dispatch signal with a real RDS group stream; loops seamlessly
    bits = rds_mod.ps_group_bits(0x54A8, "PEBBLES ", repeats=24)
    sym = np.asarray(rds_mod.differential_encode(bits), np.float64) * 2 - 1
    t = np.arange(K * N) / FS
    sym_idx = np.minimum((t * rds_mod.RDS_BAUD).astype(np.int64),
                         len(sym) - 1)
    frac = t * rds_mod.RDS_BAUD - sym_idx
    biphase = sym[sym_idx] * np.where(frac < 0.5, 1.0, -1.0)
    comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.06 * biphase * np.cos(2 * np.pi * 57000.0 * t))
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
          ).astype(np.complex64)
    plane = np.concatenate(
        [np.broadcast_to(iq.real.astype(np.float32)[:, None], (K * N, C)),
         np.broadcast_to(iq.imag.astype(np.float32)[:, None], (K * N, C))],
        axis=1)
    iq_dev = jax.jit(lambda b: b + 0)(jnp.asarray(plane))

    import functools

    step = jax.jit(functools.partial(rx._step_many_impl, spectra=False))
    check = jax.jit(lambda o: (jnp.all(jnp.isfinite(o["audio"])),
                               jnp.all(o["pilot_locked"][-1]),
                               jnp.max(jnp.abs(o["audio"]))))

    state, out = step(state, params, iq_dev)
    jax.block_until_ready(out["audio"])
    dec = rds_mod.RdsBlockDecoder()
    grp = rds_mod.RdsGroupDecoder()
    dispatches = 0
    bad = 0
    peak = 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < SECONDS:
        state, out = step(state, params, iq_dev)
        fin, locked, mx = check(out)
        if not bool(fin) or not bool(locked):
            bad += 1
        peak = max(peak, float(mx))
        dec.feed_symbols(np.asarray(out["rds_soft"])[:, 0].reshape(-1))
        for g in dec.groups:
            grp.decode(g)
        dec.groups.clear()
        dispatches += 1
    wall = time.perf_counter() - t0
    samples = dispatches * K * N * C
    total_blocks = dec.blocks_ok + dec.block_errors
    print(json.dumps({
        "seconds": round(wall, 1),
        "dispatches": dispatches,
        "blocks": dispatches * K,
        "msps_sustained": round(samples / wall / 1e6, 1),
        "bad_dispatches": bad,
        "audio_peak": round(peak, 3),
        "rds_blocks_ok": dec.blocks_ok,
        "rds_block_errors": dec.block_errors,
        "rds_bler": round(dec.block_errors / max(1, total_blocks), 4),
        "rds_ps": grp.ps_name,
        "rds_synced": dec.synced,
    }))


if __name__ == "__main__":
    main()
