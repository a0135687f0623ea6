"""WFM stereo + RDS: synthesize a broadcast FM station (stereo pilot + RDS
PS name), demodulate, print stereo separation and the decoded station name."""

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod import rds
from pebblesdr_tpu.demod.modes import DemodMode

FS, N, NB = 2_048_000, 32768, 30

# RDS bitstream: PS name "PEBL FM " on PI 0x54A8 (-> callsign WAAA)
bits = []
for _ in range(20):
    for seg in range(4):
        b = (0 << 12) | (5 << 5) | seg
        d = (ord("PEBL FM "[2 * seg]) << 8) | ord("PEBL FM "[2 * seg + 1])
        bits.extend(rds.encode_group(0x54A8, b, 0xE0E0, d))
diff, last = [], 0
for b in bits:
    last ^= b
    diff.append(last)
sym = np.asarray(diff, np.float64) * 2 - 1

t = np.arange(NB * N) / FS
sidx = np.minimum((t * rds.RDS_BAUD).astype(np.int64), len(sym) - 1)
frac = t * rds.RDS_BAUD - sidx
biphase = sym[sidx] * np.where(frac < 0.5, 1.0, -1.0)
left = np.sin(2 * np.pi * 1000.0 * t)
right = np.sin(2 * np.pi * 3000.0 * t)
comp = (0.4 * (left + right) / 2
        + 0.4 * (left - right) / 2 * np.sin(2 * 2 * np.pi * 19000.0 * t)
        + 0.09 * np.sin(2 * np.pi * 19000.0 * t)
        + 0.05 * biphase * np.cos(2 * np.pi * 57000.0 * t))
phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))).astype(np.complex64)

rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.FMS, rds=True))
state = jax.jit(lambda: rx.init_state())()
params = rx.default_params(300_000.0)
block_dec = rds.RdsBlockDecoder()
audio = []
for i in range(NB):
    blk = iq[i * N:(i + 1) * N]
    ri = np.stack([blk.real, blk.imag]).astype(np.float32)
    state, out = rx.step(state, params, jax.lax.complex(
        jnp.asarray(ri[None, 0]), jnp.asarray(ri[None, 1])))
    audio.append(np.asarray(out["audio"])[0])
    block_dec.feed_symbols(np.asarray(out["rds_soft"])[0])

a = np.concatenate(audio, axis=-1)[:, 10 * rx.audio_blk:]


def amp(x, f):
    tt = np.arange(x.shape[-1]) / 48000.0
    b = np.stack([np.cos(2 * np.pi * f * tt), np.sin(2 * np.pi * f * tt)])
    c, *_ = np.linalg.lstsq(b.T, x, rcond=None)
    return float(np.hypot(*c))


print(f"pilot locked: {bool(np.asarray(out['pilot_locked'])[0])}")
print(f"L: 1k={amp(a[0],1000):.3f} 3k={amp(a[0],3000):.3f}   "
      f"R: 1k={amp(a[1],1000):.3f} 3k={amp(a[1],3000):.3f}")
print(f"stereo separation: {20*np.log10(amp(a[0],1000)/max(amp(a[1],1000),1e-9)):.1f} dB")
g = rds.RdsGroupDecoder()
for grp in block_dec.groups:
    g.decode(grp)
print(f"RDS: PS={g.ps_name!r} PI=0x{g.pi:04X} callsign={g.callsign} "
      f"({block_dec.blocks_ok} blocks, {block_dec.block_errors} errors)")
