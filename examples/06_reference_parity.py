"""Round-5 flagship: parity against the reference's OWN compiled DSP core.

tools/refharness builds PebbleSDR's actual pebblelib/application sources
(read-only, Qt surface stubbed) into a headless CLI; this example runs the
same broadband AM signal through that binary and through this chain and
prints the demodulated-sample agreement — the BASELINE.md north-star
measured against the reference's arithmetic, not a reimplementation.

Requires /root/reference and g++ (skips cleanly otherwise).

Run on the CPU or the card:  python examples/06_reference_parity.py
"""

import os
import sys

if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import ref_parity as rp          # noqa: E402
from tools import parity_harness as ph      # noqa: E402
from pebblesdr_tpu.demod.modes import DemodMode  # noqa: E402


def main() -> int:
    if not rp.refchain_available():
        print("reference tree or g++ unavailable — nothing to compare")
        return 0
    print("building the reference harness (cached after the first run)...")
    rp.build_refchain()

    fs = 2_048_000
    t = np.arange(int(fs * 0.75)) / fs
    env = (1 + 0.5 * np.cos(2 * np.pi * 1000.0 * t)
           + 0.3 * np.cos(2 * np.pi * 2300.0 * t + 0.5)) / 2
    iq = (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)).astype(np.complex64)
    rng = np.random.default_rng(0)
    iq += (1e-3 * (rng.standard_normal(len(t))
                   + 1j * rng.standard_normal(len(t)))).astype(np.complex64)

    print("running the chain...")
    got, rx = ph.run_chain(iq, fs, DemodMode.AM, 250_000.0, 32768)
    print("running the reference's compiled chain "
          "(Mixer -> Decimator -> CFastFIR -> AGC -> Demod_AM -> "
          "CFractResampler)...")
    ref = rp.run_refchain(iq.astype(np.complex128), fs, "am", 250_000.0,
                          rx.info.lo_cut, rx.info.hi_cut, agc="off",
                          audio_rate=rx.cfg.audio_rate)
    snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                         skip=rx.cfg.audio_rate // 2)
    print(f"\nAM demodulated-sample parity vs the reference binary: "
          f"{snr:.1f} dB")
    print("(tests/test_refparity.py asserts this plus SAM/NFM/WFM-stereo/"
          "USB/LSB/AGC variants and Goertzel tone powers)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
