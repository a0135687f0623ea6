"""Chain parity vs the REFERENCE'S OWN compiled DSP core.

tools/refharness builds PebbleSDR's actual pebblelib/application sources
(read-only from /root/reference, Qt surface stubbed) into a headless CLI
that runs IQ through the reference receive chain
(application/receiver.cpp:758-1009).  These tests feed the SAME broadband
IQ to that binary and to this chain and assert demodulated-sample
parity — the BASELINE.md north-star target, measured against the
reference's arithmetic rather than an independent golden.

Thresholds are ~5-10 dB below measured values (AM 66.5, AM+AGC 60.7,
SAM-rails 66.0, USB/LSB 86.0/86.1, CWU/CWL 64.0/63.9, DSB 73.9, FMN 99.0,
WFM-mono 104.2, WFM-stereo L 95.7 / R 79.8, NB1 58.5 dB); residuals are
the documented filter-design deviations (PARITY.md) plus float32 vs
float64 arithmetic.
"""

import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from tools import ref_parity as rp  # noqa: E402

pytestmark = pytest.mark.skipif(
    not rp.refchain_available(),
    reason="reference tree or g++ unavailable")

FS = 2_048_000


@pytest.fixture(scope="module")
def refchain_bin():
    return rp.build_refchain()


def _run_chain(iq, mode, tune, params_update=None, **cfg_kw):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=32768, mode=mode,
                         **cfg_kw)
    rx = Receiver(cfg)
    state = jax.jit(lambda: rx.init_state())()
    params = rx.default_params(tune)
    if params_update:
        params = dataclasses.replace(params, **{
            k: jnp.asarray(v, jnp.float32) for k, v in params_update.items()})
    outs = []
    frames = cfg.frames_per_buffer
    for i in range(len(iq) // frames):
        blk = iq[i * frames:(i + 1) * frames]
        ri = np.stack([blk.real, blk.imag]).astype(np.float32)[None]
        state, out = rx.step(state, params, jax.lax.complex(
            jnp.asarray(ri[:, 0]), jnp.asarray(ri[:, 1])))
        outs.append(np.asarray(out["audio"])[0])
    return np.concatenate(outs, axis=-1), rx


def _am_fixture(seconds=0.75, carrier=250_000.0):
    t = np.arange(int(FS * seconds)) / FS
    env = (1 + 0.5 * np.cos(2 * np.pi * 1000.0 * t)
           + 0.3 * np.cos(2 * np.pi * 2300.0 * t + 0.5)) / 2
    iq = (0.5 * env * np.exp(2j * np.pi * carrier * t)).astype(np.complex64)
    rng = np.random.default_rng(0)
    iq += (1e-3 * (rng.standard_normal(len(t))
                   + 1j * rng.standard_normal(len(t)))).astype(np.complex64)
    return iq


class TestReferenceBinaryParity:
    def test_am_vs_reference(self, refchain_bin, tmp_path):
        from pebblesdr_tpu.demod.modes import DemodMode

        iq = _am_fixture()
        got, rx = _run_chain(iq, DemodMode.AM, 250_000.0, agc_mode="off")
        ref = rp.run_refchain(iq.astype(np.complex128), FS, "am", 250_000.0,
                              rx.info.lo_cut, rx.info.hi_cut, agc="off",
                              audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        assert snr > 55.0, f"AM vs reference binary: {snr:.1f} dB"

    @pytest.mark.parametrize("agc", ["med", "fast", "slow", "long"])
    def test_am_agc_vs_reference(self, refchain_bin, tmp_path, agc):
        """AGC knee/hang arithmetic parity (agc.cpp:84-299) across the
        mode table's decay constants."""
        from pebblesdr_tpu.demod.modes import DemodMode

        iq = _am_fixture()
        got, rx = _run_chain(iq, DemodMode.AM, 250_000.0, agc_mode=agc)
        ref = rp.run_refchain(iq.astype(np.complex128), FS, "am", 250_000.0,
                              rx.info.lo_cut, rx.info.hi_cut, agc=agc,
                              agc_thresh=20, audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        assert snr > 50.0, f"AM agc={agc} vs reference binary: {snr:.1f} dB"

    def test_sam_rails_vs_reference(self, refchain_bin, tmp_path):
        """SAM with the reference's exact per-rail phasing split
        (demod_sam.cpp:83-112 + CFir::ProcessFilter CPX overload)."""
        from pebblesdr_tpu.demod.modes import DemodMode

        iq = _am_fixture(carrier=250_200.0)  # PLL must pull in 200 Hz
        got, rx = _run_chain(iq, DemodMode.SAM, 250_000.0, agc_mode="off",
                             sam_sideband="rails")
        ref = rp.run_refchain(iq.astype(np.complex128), FS, "sam", 250_000.0,
                              rx.info.lo_cut, rx.info.hi_cut, agc="off",
                              audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        mono = (ref[0] + ref[1]) / 2
        snr = rp.aligned_snr(mono, got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        assert snr > 55.0, f"SAM rails vs reference binary: {snr:.1f} dB"

    @pytest.mark.parametrize("mode_s,sign", [("usb", +1), ("lsb", -1)])
    def test_ssb_vs_reference(self, refchain_bin, tmp_path, mode_s, sign):
        """simpleUSB/simpleLSB (re +/- im after the bandpass) through the
        shared front end; two-tone voice-band fixture on the demodulated
        sideband."""
        from pebblesdr_tpu.demod.modes import DemodMode

        t = np.arange(int(FS * 0.75)) / FS
        iq = (0.3 * np.exp(2j * np.pi * (400_000.0 + sign * 700.0) * t)
              + 0.2 * np.exp(2j * np.pi * (400_000.0 + sign * 1900.0) * t)
              ).astype(np.complex64)
        rng = np.random.default_rng(3)
        iq += (5e-4 * (rng.standard_normal(len(t))
                       + 1j * rng.standard_normal(len(t)))
               ).astype(np.complex64)
        mode = DemodMode.USB if mode_s == "usb" else DemodMode.LSB
        got, rx = _run_chain(iq, mode, 400_000.0, agc_mode="off")
        ref = rp.run_refchain(iq.astype(np.complex128), FS, mode_s,
                              400_000.0, rx.info.lo_cut, rx.info.hi_cut,
                              agc="off", audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        assert snr > 70.0, f"{mode_s.upper()} vs reference binary: {snr:.1f} dB"

    def test_fmn_vs_reference(self, refchain_bin, tmp_path):
        from pebblesdr_tpu.demod.modes import DemodMode

        t = np.arange(int(FS * 0.75)) / FS
        mod = (np.sin(2 * np.pi * 700.0 * t)
               + 0.6 * np.sin(2 * np.pi * 1900.0 * t + 0.7)
               + 0.3 * np.sin(2 * np.pi * 2600.0 * t + 1.1))
        ph_mod = 2 * np.pi * np.cumsum(3000.0 * mod) / FS
        iq = (0.5 * np.exp(1j * (2 * np.pi * 150_000.0 * t + ph_mod))
              ).astype(np.complex64)
        rng = np.random.default_rng(1)
        iq += (2e-4 * (rng.standard_normal(len(t))
                       + 1j * rng.standard_normal(len(t)))
               ).astype(np.complex64)
        got, rx = _run_chain(iq, DemodMode.FMN, 150_000.0, agc_mode="off")
        ref = rp.run_refchain(iq.astype(np.complex128), FS, "fmn", 150_000.0,
                              rx.info.lo_cut, rx.info.hi_cut, agc="off",
                              audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        assert snr > 80.0, f"FMN vs reference binary: {snr:.1f} dB"

    def test_goertzel_power_vs_reference(self, refchain_bin, tmp_path):
        """Modem-layer parity: per-frame tone power of the reference's OWN
        Goertzel (pebblelib/goertzel.cpp Lyons recurrence, compiled into
        refchain --mode tone) vs ops.goertzel's matmul DFT on the same
        amplitude-modulated noisy tone.  The reference consumes N+1 samples
        per result (post-increment accounting) — frames align at that
        stride."""
        import subprocess

        import jax.numpy as jnp

        from pebblesdr_tpu.ops import goertzel as gz

        fs, n, f = 8000.0, 512, 1000.0
        t = np.arange(int(fs * 2.0)) / fs
        rng = np.random.default_rng(0)
        audio = (np.sin(2 * np.pi * f * t)
                 * (0.5 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
                 + 0.05 * rng.standard_normal(len(t)))
        raw = np.zeros(2 * len(audio))
        raw[0::2] = audio
        inp = str(tmp_path / "tone_in.f64")
        outp = str(tmp_path / "tone_out.f64")
        raw.tofile(inp)
        subprocess.run([refchain_bin, "--mode", "tone", "--rate", str(fs),
                        "--tone-freq", str(f), "--tone-n", str(n),
                        "--in", inp, "--out", outp], check=True)
        p_ref = np.fromfile(outp)
        stride = n + 1
        nres = min(len(p_ref), len(audio) // stride)
        frames = np.stack([audio[k * stride:k * stride + n]
                           for k in range(nres)])[None]
        p_mine = np.asarray(gz.goertzel_power(
            jnp.asarray(frames.astype(np.float32)),
            jnp.asarray(gz.dft_vectors([f], fs, n))))[0, :, 0]
        p_ref = p_ref[:nres]
        s = np.sum(p_ref * p_mine) / np.sum(p_mine ** 2)
        dev = 10 * np.log10(np.maximum(p_ref, 1e-12)
                            / np.maximum(s * p_mine, 1e-12))
        assert np.abs(dev).max() < 0.2, \
            f"Goertzel power deviation {np.abs(dev).max():.3f} dB"

    @pytest.mark.parametrize("mode_s,sign", [("cwu", +1), ("cwl", -1)])
    def test_cw_vs_reference(self, refchain_bin, tmp_path, mode_s, sign):
        """CW modes = the reference's SSB passthrough behind the narrow CW
        bandpass (demod.cpp:127-138 routes CWL/CWU to the same path;
        Pebble's mode table centers the 800 Hz mask on the +/-1000 Hz CW
        offset, demod.cpp:34-35) with the AGC_FAST preset — keyed-carrier
        fixture exercises the knee/hang dynamics on on/off edges."""
        from pebblesdr_tpu.demod.modes import DemodMode

        t = np.arange(int(FS * 0.75)) / FS
        # ~20 WPM keying (dit ~60 ms) with 5 ms raised-cosine edges
        key_rate = 8.0
        key = 0.5 * (1 + np.sign(np.sin(2 * np.pi * key_rate * t) + 0.3))
        edge = int(FS * 0.005)
        kern = 0.5 * (1 - np.cos(np.pi * np.arange(1, edge + 1) / edge))
        key = np.convolve(key, kern / kern.sum(), mode="same")
        iq = (0.4 * key * np.exp(2j * np.pi * (300_000.0 + sign * 1000.0) * t)
              ).astype(np.complex64)
        rng = np.random.default_rng(7)
        iq += (3e-4 * (rng.standard_normal(len(t))
                       + 1j * rng.standard_normal(len(t)))
               ).astype(np.complex64)
        mode = DemodMode.CWU if mode_s == "cwu" else DemodMode.CWL
        got, rx = _run_chain(iq, mode, 300_000.0, agc_mode="fast")
        ref = rp.run_refchain(iq.astype(np.complex128), FS,
                              "usb" if mode_s == "cwu" else "lsb",
                              300_000.0, rx.info.lo_cut, rx.info.hi_cut,
                              agc="fast", agc_thresh=20,
                              audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        print(f"{mode_s.upper()} vs reference binary: {snr:.1f} dB")
        assert snr > 45.0, f"{mode_s.upper()} vs reference binary: {snr:.1f} dB"

    def test_dsb_vs_reference(self, refchain_bin, tmp_path):
        """DSB: the reference passes the bandpassed IQ through undemodulated
        (Demod::processBlock default case, demod.cpp:135-138); the chain's
        dsb_demod emits 2*re — identical up to the scale the equalizer
        absorbs.  Suppressed-carrier two-tone fixture."""
        from pebblesdr_tpu.demod.modes import DemodMode

        t = np.arange(int(FS * 0.75)) / FS
        m = (0.6 * np.cos(2 * np.pi * 900.0 * t)
             + 0.4 * np.cos(2 * np.pi * 2100.0 * t + 0.4))
        iq = (0.5 * m * np.exp(2j * np.pi * 250_000.0 * t)
              ).astype(np.complex64)
        rng = np.random.default_rng(9)
        iq += (5e-4 * (rng.standard_normal(len(t))
                       + 1j * rng.standard_normal(len(t)))
               ).astype(np.complex64)
        got, rx = _run_chain(iq, DemodMode.DSB, 250_000.0, agc_mode="off")
        ref = rp.run_refchain(iq.astype(np.complex128), FS, "dsb", 250_000.0,
                              rx.info.lo_cut, rx.info.hi_cut, agc="off",
                              audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        print(f"DSB vs reference binary: {snr:.1f} dB")
        assert snr > 55.0, f"DSB vs reference binary: {snr:.1f} dB"

    def test_noise_blanker_vs_reference(self, refchain_bin, tmp_path):
        """Device-rate spike blanker: the reference NB1 (noiseblanker.cpp:
        45-76, mean-|x| EWMA + 7-sample countdown behind a 2-sample delay)
        vs the chain's chunked power-EWMA + causal dilation (documented
        deviation — scanops.noise_blanker_chunked).  Both run on the same
        impulse-corrupted AM; parity is measured on the demodulated audio
        (differences are localized to the differing blank windows)."""
        from pebblesdr_tpu.demod.modes import DemodMode

        iq = _am_fixture()
        rng = np.random.default_rng(11)
        pos = rng.choice(len(iq) - 16, size=120, replace=False) + 8
        spikes = np.zeros(len(iq), np.complex64)
        spikes[pos] = (20.0 * np.exp(2j * np.pi * rng.random(len(pos)))
                       ).astype(np.complex64)
        iq_spiky = iq + spikes
        got, rx = _run_chain(iq_spiky, DemodMode.AM, 250_000.0,
                             agc_mode="off", enable_noise_blanker=True)
        ref = rp.run_refchain(iq_spiky.astype(np.complex128), FS, "am",
                              250_000.0, rx.info.lo_cut, rx.info.hi_cut,
                              agc="off", audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path), nb1=True)
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        # Functional: blanking must actually remove the impulses — compare
        # each NB'd run against the clean-channel chain output.
        got_clean, _ = _run_chain(iq, DemodMode.AM, 250_000.0, agc_mode="off")
        got_spiky, _ = _run_chain(iq_spiky, DemodMode.AM, 250_000.0,
                                  agc_mode="off")
        base = rp.aligned_snr(got_clean.astype(np.float64),
                              got_spiky.astype(np.float64),
                              skip=rx.cfg.audio_rate // 2)
        nbd = rp.aligned_snr(got_clean.astype(np.float64),
                             got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        print(f"NB1 vs reference binary: {snr:.1f} dB; "
              f"NB gain {nbd - base:.1f} dB (nb {nbd:.1f} vs open {base:.1f})")
        assert nbd > base + 6.0, \
            f"NB gain {nbd - base:.1f} dB (nb {nbd:.1f} vs open {base:.1f})"
        assert snr > 30.0, f"NB1 vs reference binary: {snr:.1f} dB"

    def test_noise_blanker2_vs_reference(self, refchain_bin, tmp_path):
        """NB2 (average substitution): the reference substitutes a 0.75/0.25
        complex signal EWMA at spikes (noiseblanker.cpp:79-99); the chain's
        'average' mode substitutes the RMS-envelope-scaled sample — a
        documented deviation, so this row is a measured bound plus the
        functional impulse-rejection assertion."""
        from pebblesdr_tpu.demod.modes import DemodMode

        iq = _am_fixture()
        rng = np.random.default_rng(13)
        pos = rng.choice(len(iq) - 16, size=120, replace=False) + 8
        spikes = np.zeros(len(iq), np.complex64)
        spikes[pos] = (20.0 * np.exp(2j * np.pi * rng.random(len(pos)))
                       ).astype(np.complex64)
        iq_spiky = iq + spikes
        got, rx = _run_chain(iq_spiky, DemodMode.AM, 250_000.0,
                             agc_mode="off", enable_noise_blanker="average")
        ref = rp.run_refchain(iq_spiky.astype(np.complex128), FS, "am",
                              250_000.0, rx.info.lo_cut, rx.info.hi_cut,
                              agc="off", audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path), nb2=True)
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        got_clean, _ = _run_chain(iq, DemodMode.AM, 250_000.0, agc_mode="off")
        got_spiky, _ = _run_chain(iq_spiky, DemodMode.AM, 250_000.0,
                                  agc_mode="off")
        base = rp.aligned_snr(got_clean.astype(np.float64),
                              got_spiky.astype(np.float64),
                              skip=rx.cfg.audio_rate // 2)
        nbd = rp.aligned_snr(got_clean.astype(np.float64),
                             got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        print(f"NB2 vs reference binary: {snr:.1f} dB; "
              f"NB2 gain {nbd - base:.1f} dB (nb {nbd:.1f} vs open {base:.1f})")
        assert nbd > base + 6.0, \
            f"NB2 gain {nbd - base:.1f} dB (nb {nbd:.1f} vs open {base:.1f})"
        assert snr > 25.0, f"NB2 vs reference binary: {snr:.1f} dB"

    def test_iq_balance_vs_reference(self, refchain_bin, tmp_path):
        """Static IQ-balance correction (iqbalance.cpp:65-78: I' = g*I,
        Q' = Q + p*I) applied by both chains to the same imbalanced AM
        capture with the same factors.  The reference's compiled variant
        additionally runs the dttsp/N4HY adaptive recurrence
        (iqbalance.cpp:70-83 #else) on the corrected stream — acting on the
        near-zero residual, so the row stays tight."""
        from pebblesdr_tpu.demod.modes import DemodMode

        iq = _am_fixture()
        # impose a gain/phase imbalance, then hand both chains the exact
        # inverse static correction
        ib = (1.05 * iq.real + 1j * (iq.imag - 0.03 * iq.real)
              ).astype(np.complex64)
        g, p = 1.0 / 1.05, 0.03 / 1.05
        got, rx = _run_chain(ib, DemodMode.AM, 250_000.0, agc_mode="off",
                             params_update={"iq_gain": g, "iq_phase": p})
        ref = rp.run_refchain(ib.astype(np.complex128), FS, "am", 250_000.0,
                              rx.info.lo_cut, rx.info.hi_cut, agc="off",
                              audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path), iq_bal=(g, p))
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        print(f"IQ balance vs reference binary: {snr:.1f} dB")
        assert snr > 45.0, f"IQ balance vs reference binary: {snr:.1f} dB"

    def test_anf_vs_reference(self, refchain_bin, tmp_path):
        """NoiseFilter ANF (dttsp lmadf, noisefilter.cpp:28-106: 45-tap
        LMS predictor behind a 64-sample delay, output = the correlated
        part x1.25).  The chain runs the same constants with block-LMS
        updates (documented deviation 4) — a measured row plus the
        functional assertion that both pull the CW tone out of the noise."""
        from pebblesdr_tpu.demod.modes import DemodMode

        t = np.arange(int(FS * 0.75)) / FS
        iq = (0.3 * np.exp(2j * np.pi * (400_000.0 + 800.0) * t)
              ).astype(np.complex64)
        rng = np.random.default_rng(17)
        iq_noisy = iq + (0.5 * (rng.standard_normal(len(t))
                                + 1j * rng.standard_normal(len(t)))
                         ).astype(np.complex64)
        got, rx = _run_chain(iq_noisy, DemodMode.USB, 400_000.0,
                             agc_mode="off", enable_anf=True)
        ref = rp.run_refchain(iq_noisy.astype(np.complex128), FS, "usb",
                              400_000.0, rx.info.lo_cut, rx.info.hi_cut,
                              agc="off", audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path), anf=True)
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        # behavioral parity on the noise-rejection GAIN: at the dttsp
        # constants this ANF is near-neutral on broadband noise (the
        # reference's own gain measures ~-1.2 dB here — LMS misadjustment
        # exceeds the suppression); assert our gain tracks the reference's
        # rather than demanding an absolute improvement neither achieves
        got_clean, _ = _run_chain(iq, DemodMode.USB, 400_000.0,
                                  agc_mode="off")
        got_noisy, _ = _run_chain(iq_noisy, DemodMode.USB, 400_000.0,
                                  agc_mode="off")
        base = rp.aligned_snr(got_clean.astype(np.float64),
                              got_noisy.astype(np.float64),
                              skip=rx.cfg.audio_rate // 2)
        nfd = rp.aligned_snr(got_clean.astype(np.float64),
                             got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        ref_clean = rp.run_refchain(iq.astype(np.complex128), FS, "usb",
                                    400_000.0, rx.info.lo_cut,
                                    rx.info.hi_cut, agc="off",
                                    audio_rate=rx.cfg.audio_rate,
                                    tmpdir=str(tmp_path))
        ref_noisy = rp.run_refchain(iq_noisy.astype(np.complex128), FS,
                                    "usb", 400_000.0, rx.info.lo_cut,
                                    rx.info.hi_cut, agc="off",
                                    audio_rate=rx.cfg.audio_rate,
                                    tmpdir=str(tmp_path))
        ref_base = rp.aligned_snr(ref_clean[0], ref_noisy[0],
                                  skip=rx.cfg.audio_rate // 2)
        ref_gain = rp.aligned_snr(ref_clean[0], ref[0],
                                  skip=rx.cfg.audio_rate // 2) - ref_base
        our_gain = nfd - base
        print(f"ANF vs reference binary: {snr:.1f} dB; "
              f"gain ours {our_gain:+.1f} vs reference {ref_gain:+.1f} dB")
        assert our_gain > ref_gain - 1.5, (our_gain, ref_gain)
        assert snr > 15.0, f"ANF vs reference binary: {snr:.1f} dB"

    def test_wfm_mono_vs_reference(self, refchain_bin, tmp_path):
        """FM-Mono: discriminator + mono LP + deemphasis
        (demod_wfm.cpp:processDataMono), reference-geometry (wfm_hq)
        front — no pilot/demux in play, so this isolates the
        discriminator+deemphasis arithmetic."""
        from pebblesdr_tpu.demod.modes import DemodMode

        t = np.arange(int(FS * 0.75)) / FS
        prog = (0.7 * np.sin(2 * np.pi * 1000.0 * t)
                + 0.3 * np.sin(2 * np.pi * 3400.0 * t + 0.6))
        phm = 2 * np.pi * np.cumsum(75000.0 * 0.6 * prog) / FS
        iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phm))
              ).astype(np.complex64)
        got, rx = _run_chain(iq, DemodMode.FMM, 300_000.0, wfm_hq=True)
        ref = rp.run_refchain(iq.astype(np.complex128), FS, "fmm", 300_000.0,
                              -100000, 100000,
                              audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        snr = rp.aligned_snr(ref[0], got.astype(np.float64),
                             skip=rx.cfg.audio_rate // 2)
        print(f"WFM mono vs reference binary: {snr:.1f} dB")
        assert snr > 80.0, f"WFM mono vs reference binary: {snr:.1f} dB"

    def test_wfm_stereo_vs_reference(self, refchain_bin, tmp_path):
        """Pilot PLL + stereo demux + deemphasis parity
        (demod_wfm.cpp:255-365), reference-geometry (wfm_hq) front."""
        from pebblesdr_tpu.demod.modes import DemodMode

        t = np.arange(int(FS * 1.0)) / FS
        th = 2 * np.pi * 19000.0 * t
        prog = (0.8 * np.sin(2 * np.pi * 1000.0 * t)
                + 0.4 * np.sin(2 * np.pi * 2700.0 * t + 0.9))
        comp = (0.45 * prog + 0.1 * np.sin(th)
                + 0.45 * prog * np.sin(2 * th))
        phm = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phm))
              ).astype(np.complex64)
        got, rx = _run_chain(iq, DemodMode.FMS, 300_000.0, wfm_hq=True)
        ref = rp.run_refchain(iq.astype(np.complex128), FS, "fms", 300_000.0,
                              -100000, 100000,
                              audio_rate=rx.cfg.audio_rate,
                              tmpdir=str(tmp_path))
        sl = rp.aligned_snr(ref[0], got[0].astype(np.float64),
                            skip=rx.cfg.audio_rate // 2)
        sr = rp.aligned_snr(ref[1], got[1].astype(np.float64),
                            skip=rx.cfg.audio_rate // 2)
        assert sl > 80.0, f"WFM stereo L vs reference binary: {sl:.1f} dB"
        assert sr > 65.0, f"WFM stereo R vs reference binary: {sr:.1f} dB"
