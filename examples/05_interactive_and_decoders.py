"""Round-4 features in one tour: the front-end noise blanker, CTCSS tone
squelch, the DTMF dial decoder over the NFM chain, and the live control
surface driven by scripted key events.

Run on the CPU or the card:  python examples/05_interactive_and_decoders.py
"""

import numpy as np
import jax.numpy as jnp

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode
from pebblesdr_tpu.modem import dtmf
from pebblesdr_tpu.serve.control import ControlSurface

FS, N = 2_048_000, 32768

# ---------------------------------------------------------------- fixture:
# an NFM station at +300 kHz carrying a CTCSS 123.0 Hz access tone and the
# dial string "2468", plus impulse noise for the blanker to eat
nb_blocks = 80
t = np.arange(nb_blocks * N) / FS
dial = dtmf.encode_dtmf("2468", 48000.0, tone_ms=80, gap_ms=80)
afull = np.zeros(int(nb_blocks * N / FS * 48000) + 1, np.float32)
afull[24000:24000 + len(dial)] = dial          # dial begins 0.5 s in
voice = np.interp(t, np.arange(len(afull)) / 48000.0, afull)
dev = 2500.0 * voice + 500.0 * np.sin(2 * np.pi * 123.0 * t)
phase = 2 * np.pi * np.cumsum(dev) / FS
iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))
      ).astype(np.complex64)
rng = np.random.default_rng(0)
spikes = rng.choice(len(iq), 200, replace=False)
iq[spikes] += 8.0 - 8.0j                       # impulse noise

# ---------------------------------------------------------------- receiver:
# FMN + noise blanker (in the front end) + CTCSS squelch
cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, mode=DemodMode.FMN,
                     enable_noise_blanker=True, ctcss_tone=123.0)
rx = Receiver(cfg)
state = rx.init_state()
params = rx.default_params(300_000.0)

# the live control surface (what the CLI binds to the keyboard) — here we
# script it: nudge the squelch up twice mid-run; params-only events reuse
# the SAME compiled step
surface = ControlSurface(rx, params, 300_000.0)

modem = dtmf.DtmfModem(48000.0)
dec = dtmf.DtmfDecoder()
audio_buf = np.zeros(0, np.float32)
opens = []
for i in range(nb_blocks):
    if i == 10:
        for key in ("s", "s"):          # squelch -10 dB, then -7 dB
            print("*", surface.handle(key))
    state, out = rx.step(state, surface.params,
                         jnp.asarray(iq[None, i * N:(i + 1) * N]))
    opens.append(bool(np.asarray(out["ctcss_open"])[0]))
    audio_buf = np.concatenate(
        [audio_buf, np.asarray(out["audio"])[0].astype(np.float32)])

n_use = (len(audio_buf) // modem.frame) * modem.frame
dec.feed(np.asarray(modem.detect(jnp.asarray(audio_buf[None, :n_use])))[0])

print(f"CTCSS opened on block {opens.index(True)} "
      f"(coherent-EWMA integration)" if any(opens) else "CTCSS never opened")
print(f"decoded dial string: {dec.digits!r}")
assert dec.digits == "2468", dec.digits
print("ok — blanker + CTCSS + DTMF + control surface all live")
