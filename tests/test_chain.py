"""End-to-end receive-chain tests (the automated TestBench, SURVEY.md §4):
inject calibrated signals, assert demodulated output amplitude/SNR."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode

FS = 2_048_000
N = 32768


def run_chain(rx, iq, params, nblocks):
    state = rx.init_state()
    outs = []
    last = None
    for i in range(nblocks):
        state, out = rx.step(state, params, jnp.asarray(iq[:, i * N:(i + 1) * N]))
        outs.append(np.asarray(out["audio"]))
        last = out
    return np.concatenate(outs, axis=-1), last, state


def tone_fit(x, f, rate):
    t = np.arange(x.shape[-1]) / rate
    basis = np.stack([np.cos(2 * np.pi * f * t), np.sin(2 * np.pi * f * t),
                      np.ones_like(t)])
    coef, *_ = np.linalg.lstsq(basis.T, x, rcond=None)
    resid = x - coef @ basis
    amp = np.hypot(coef[0], coef[1])
    return amp, resid


def am_iq(carrier_hz, mod_hz, depth, nblocks, amp=0.5):
    t = np.arange(nblocks * N) / FS
    env = (1 + depth * np.cos(2 * np.pi * mod_hz * t)) / 2
    return (amp * env * np.exp(2j * np.pi * carrier_hz * t)).astype(np.complex64)[None]


class TestAMChain:
    def test_recovers_modulation(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        nb = 24
        iq = am_iq(250_000.0, 1000.0, 0.8, nb)
        params = rx.default_params(250_000.0)
        audio, _, _ = run_chain(rx, iq, params, nb)
        tail = audio[0, -4 * rx.audio_blk:]
        amp, resid = tone_fit(tail, 1000.0, 48000.0)
        assert amp == pytest.approx(0.5 * 0.8 / 2, rel=0.05)

    def test_mute_and_gain(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        iq = am_iq(250_000.0, 1000.0, 0.8, 2)
        params = rx.default_params(250_000.0)
        params = dataclasses.replace(params, mute=jnp.asarray(True))
        audio, _, _ = run_chain(rx, iq, params, 2)
        assert np.all(audio == 0.0)

    def test_squelch_closes_on_empty_channel(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        nb = 4
        iq = am_iq(250_000.0, 1000.0, 0.8, nb)
        # tune 500 kHz away from the station; squelch threshold 6 dB SNR
        params = rx.default_params(-250_000.0)
        params = dataclasses.replace(params, squelch_db=jnp.asarray(6.0, jnp.float32))
        audio, out, _ = run_chain(rx, iq, params, nb)
        assert not bool(np.asarray(out["squelch_open"])[0])
        assert np.all(audio[:, -rx.audio_blk:] == 0.0)
        # on-station: squelch opens
        params2 = rx.retune(params, 250_000.0)
        audio2, out2, _ = run_chain(rx, iq, params2, nb)
        assert bool(np.asarray(out2["squelch_open"])[0])

    def test_smeter_tracks_level(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        params = rx.default_params(250_000.0)
        levels = []
        for amp in [0.5, 0.05]:
            iq = am_iq(250_000.0, 1000.0, 0.0, 4, amp=amp)
            _, out, _ = run_chain(rx, iq, params, 4)
            levels.append(float(np.asarray(out["smeter"]["signal_db"])[0]))
        assert levels[0] - levels[1] == pytest.approx(20.0, abs=1.5)

    def test_taps_exposed(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, taps=True)
        rx = Receiver(cfg)
        iq = am_iq(250_000.0, 1000.0, 0.8, 1)
        state = rx.init_state()
        _, out = rx.step(state, rx.default_params(250_000.0), jnp.asarray(iq))
        tp = out["taps"]
        assert tp["raw_iq"].shape == (1, N)
        assert tp["post_mixer"].shape == (1, rx.blk)
        assert tp["post_bp"].shape == (1, rx.blk)
        assert tp["post_demod"].shape == (1, rx.blk)


class TestSSBChain:
    def test_usb_tone(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.USB, agc_mode="off")
        rx = Receiver(cfg)
        nb = 8
        t = np.arange(nb * N) / FS
        # USB voice tone: carrier + 1.5 kHz -> audio at 1.5 kHz after demod
        iq = (0.4 * np.exp(2j * np.pi * (400_000.0 + 1500.0) * t)).astype(np.complex64)[None]
        params = rx.default_params(400_000.0)
        audio, _, _ = run_chain(rx, iq, params, nb)
        tail = audio[0, -4 * rx.audio_blk:]
        amp, resid = tone_fit(tail, 1500.0, 48000.0)
        snr = 10 * np.log10(amp**2 / 2 / max(np.mean(resid**2), 1e-20))
        # I+Q of A*e^{jwt} = A*sqrt(2)*sin(wt+pi/4)
        assert amp == pytest.approx(0.4 * np.sqrt(2.0), rel=0.1)
        assert snr > 40

    def test_lsb_rejects_usb_signal(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.LSB, agc_mode="off")
        rx = Receiver(cfg)
        nb = 6
        t = np.arange(nb * N) / FS
        iq = (0.4 * np.exp(2j * np.pi * (400_000.0 + 1500.0) * t)).astype(np.complex64)[None]
        params = rx.default_params(400_000.0)
        audio, _, _ = run_chain(rx, iq, params, nb)
        assert np.sqrt(np.mean(audio[0, -2 * rx.audio_blk:] ** 2)) < 0.02


class TestNFMChain:
    def test_recovers_fm_audio(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.FMN)
        rx = Receiver(cfg)
        nb = 12
        t = np.arange(nb * N) / FS
        dev = 3000.0
        mod = np.sin(2 * np.pi * 1000.0 * t)
        phase = 2 * np.pi * np.cumsum(dev * mod) / FS
        iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))).astype(np.complex64)[None]
        params = rx.default_params(300_000.0)
        audio, _, _ = run_chain(rx, iq, params, nb)
        tail = audio[0, -4 * rx.audio_blk:]
        amp, _ = tone_fit(tail, 1000.0, 48000.0)
        # deviation 3k over max_dev 5k -> amplitude 0.6
        assert amp == pytest.approx(dev / 5000.0, rel=0.1)


class TestWFMChain:
    def _composite_iq(self, nb, left_hz=1000.0, right_hz=3000.0, stereo=True):
        t = np.arange(nb * N) / FS
        left = np.sin(2 * np.pi * left_hz * t)
        right = np.sin(2 * np.pi * right_hz * t)
        if stereo:
            comp = (0.45 * (left + right) / 2
                    + 0.45 * (left - right) / 2 * np.sin(2 * 2 * np.pi * 19000.0 * t)
                    + 0.1 * np.sin(2 * np.pi * 19000.0 * t))
        else:
            comp = 0.9 * left
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        return (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))).astype(np.complex64)[None]

    def test_mono(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.FMM)
        rx = Receiver(cfg)
        nb = 8
        iq = self._composite_iq(nb, stereo=False)
        audio, _, _ = run_chain(rx, iq, rx.default_params(300_000.0), nb)
        tail = audio[0, -4 * rx.audio_blk:]
        amp, _ = tone_fit(tail, 1000.0, 48000.0)
        deemph = 1.0 / np.sqrt(1.0 + (2 * np.pi * 1000.0 * 75e-6) ** 2)
        assert amp == pytest.approx(0.9 * deemph, rel=0.05)

    def test_stereo_separation(self):
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.FMS)
        rx = Receiver(cfg)
        nb = 24
        iq = self._composite_iq(nb)
        audio, out, _ = run_chain(rx, iq, rx.default_params(300_000.0), nb)
        assert bool(np.asarray(out["pilot_locked"])[0])
        l = audio[0, 0, -6 * rx.audio_blk:]
        r = audio[0, 1, -6 * rx.audio_blk:]
        l1k, _ = tone_fit(l, 1000.0, 48000.0)
        r1k, _ = tone_fit(r, 1000.0, 48000.0)
        r3k, _ = tone_fit(r, 3000.0, 48000.0)
        l3k, _ = tone_fit(l, 3000.0, 48000.0)
        assert 20 * np.log10(l1k / max(r1k, 1e-9)) > 25, "left separation"
        assert 20 * np.log10(r3k / max(l3k, 1e-9)) > 25, "right separation"


class TestAutoIQBalance:
    def test_image_rejection_improves(self):
        """enable_iq_balance='auto': the adaptive image-reject weight runs
        INSIDE the chain (iqbalance.cpp:65-87) with its state carried in
        ReceiverState — on a deliberately imbalanced capture the image tone
        must sink over blocks (VERDICT round-1 item 6)."""
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, enable_iq_balance="auto",
                             taps=True, agc_mode="off")
        rx = Receiver(cfg)
        assert rx.init_state().iqbal is not None  # adaptive weight in state

        nblocks = 12
        f0 = 300_000.0
        t = np.arange(nblocks * N) / FS
        clean = 0.5 * np.exp(2j * np.pi * f0 * t)
        # receiver-style imbalance: gain error on I, phase leakage into Q
        i = clean.real * 1.06
        q = clean.imag + 0.08 * clean.real
        iq = (i + 1j * q).astype(np.complex64)[None]

        params = rx.default_params(f0)
        state = rx.init_state()
        rej_db = []
        for b in range(nblocks):
            state, out = rx.step(state, params,
                                 jnp.asarray(iq[:, b * N:(b + 1) * N]))
            raw = np.asarray(out["taps"]["raw_iq"])[0]  # post-balance stream
            spec = np.fft.fft(raw)
            freqs = np.fft.fftfreq(len(raw), 1.0 / FS)
            sig = np.abs(spec[np.argmin(np.abs(freqs - f0))])
            img = np.abs(spec[np.argmin(np.abs(freqs + f0))])
            rej_db.append(20 * np.log10(sig / max(img, 1e-12)))
        # the raw imbalance gives ~25 dB image rejection; the adaptive loop
        # must visibly deepen it and keep improving over blocks
        assert rej_db[-1] > rej_db[0] + 20, rej_db
        assert rej_db[-1] > 60, rej_db

    def test_state_checkpoints(self):
        """The adaptive weight lives in the state pytree: streaming across a
        state save/restore is seamless."""
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, enable_iq_balance="auto")
        rx = Receiver(cfg)
        t = np.arange(2 * N) / FS
        clean = 0.5 * np.exp(2j * np.pi * 250e3 * t)
        iq = ((clean.real * 1.05) + 1j * (clean.imag + 0.05 * clean.real)
              ).astype(np.complex64)[None]
        params = rx.default_params(250e3)
        st = rx.init_state()
        st, _ = rx.step(st, params, jnp.asarray(iq[:, :N]))
        w1 = np.asarray(st.iqbal.w)
        st, _ = rx.step(st, params, jnp.asarray(iq[:, N:]))
        w2 = np.asarray(st.iqbal.w)
        assert np.abs(w1).max() > 0  # weight is adapting
        assert not np.allclose(w1, w2)  # and keeps moving


class TestStateResume:
    def test_checkpoint_resume_bitexact(self):
        """Carry-state pytree checkpoint/resume (SURVEY.md §5): serialize the
        state mid-stream, restore, outputs must be identical."""
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM)
        rx = Receiver(cfg)
        nb = 6
        iq = am_iq(250_000.0, 1000.0, 0.8, nb)
        params = rx.default_params(250_000.0)

        state = rx.init_state()
        for i in range(3):
            state, _ = rx.step(state, params, jnp.asarray(iq[:, i * N:(i + 1) * N]))
        # checkpoint: flatten to host numpy and rebuild
        leaves, treedef = jax.tree.flatten(state)
        saved = [np.asarray(l) for l in leaves]
        restored = jax.tree.unflatten(treedef, [jnp.asarray(s) for s in saved])

        out_a = []
        out_b = []
        sa, sb = state, restored
        for i in range(3, nb):
            blk = jnp.asarray(iq[:, i * N:(i + 1) * N])
            sa, oa = rx.step(sa, params, blk)
            sb, ob = rx.step(sb, params, blk)
            out_a.append(np.asarray(oa["audio"]))
            out_b.append(np.asarray(ob["audio"]))
        np.testing.assert_array_equal(np.concatenate(out_a), np.concatenate(out_b))


class TestMultiChannel:
    def test_independent_channels(self):
        """Channel batching: two channels tuned to two different stations
        recover their own modulation (the channelizer building block)."""
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=2,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        nb = 16
        t = np.arange(nb * N) / FS
        st1 = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2 * np.exp(2j * np.pi * 250_000.0 * t)
        st2 = (1 + 0.6 * np.cos(2 * np.pi * 2000.0 * t)) / 2 * np.exp(-2j * np.pi * 450_000.0 * t)
        mix = (0.5 * (st1 + st2)).astype(np.complex64)
        iq = np.stack([mix, mix])
        params = rx.default_params([250_000.0, -450_000.0])
        audio, _, _ = run_chain(rx, iq, params, nb)
        a1, _ = tone_fit(audio[0, -4 * rx.audio_blk:], 1000.0, 48000.0)
        a2, _ = tone_fit(audio[1, -4 * rx.audio_blk:], 2000.0, 48000.0)
        x1, _ = tone_fit(audio[0, -4 * rx.audio_blk:], 2000.0, 48000.0)
        assert a1 == pytest.approx(0.5 * 0.8 / 2, rel=0.1)
        assert a2 == pytest.approx(0.5 * 0.6 / 2, rel=0.1)
        assert x1 < 0.02  # no cross-talk


class TestNoRecompile:
    def test_retune_and_bandpass_do_not_recompile(self):
        """Runtime knobs (tune, bandpass mask, squelch, gain) are jit INPUTS:
        changing them must not trigger a recompile (core design claim)."""
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        iq = am_iq(250_000.0, 1000.0, 0.8, 1)
        params = rx.default_params(250_000.0)
        state = rx.init_state()
        state, _ = rx.step(state, params, jnp.asarray(iq))
        compiles_after_first = rx._step._cache_size()
        # retune, narrow the bandpass, close squelch, change gain
        params = rx.retune(params, -300_000.0)
        params = rx.set_bandpass(params, -3000.0, 3000.0)
        params = dataclasses.replace(
            params, squelch_db=jnp.asarray(10.0, jnp.float32),
            gain=jnp.asarray(0.5, jnp.float32))
        state, _ = rx.step(state, params, jnp.asarray(iq))
        assert rx._step._cache_size() == compiles_after_first


class TestSpectraThrottle:
    def test_no_spectra_variant(self):
        """spectra=False skips display spectra but keeps squelch/smeter, and
        audio is identical to the spectra=True variant."""
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        nb = 3
        iq = am_iq(250_000.0, 1000.0, 0.8, nb)
        params = rx.default_params(250_000.0)
        sa, sb = rx.init_state(), rx.init_state()
        for i in range(nb):
            blk = jnp.asarray(iq[:, i * N:(i + 1) * N])
            sa, oa = rx.step(sa, params, blk, spectra=True)
            sb, ob = rx.step(sb, params, blk, spectra=False)
            np.testing.assert_array_equal(np.asarray(oa["audio"]),
                                          np.asarray(ob["audio"]))
        assert "spectrum" in oa and "zoomed" in oa
        assert "spectrum" not in ob and "zoomed" not in ob
        assert "smeter" in ob and "squelch_open" in ob
        # smeter identical between variants (computed from the same power)
        np.testing.assert_allclose(
            np.asarray(oa["smeter"]["snr_db"]),
            np.asarray(ob["smeter"]["snr_db"]), atol=1e-4)


class TestStepMany:
    def test_scan_matches_sequential(self):
        """step_many (K blocks per dispatch via lax.scan) must thread state
        exactly like K sequential step() calls and stack the outputs."""
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.AM, batched_many=False)
        rx = Receiver(cfg)
        nb = 4
        iq = am_iq(250_000.0, 1000.0, 0.8, nb)
        params = rx.default_params(250_000.0)

        sa = rx.init_state()
        seq_audio, seq_sm = [], []
        for i in range(nb):
            sa, oa = rx.step(sa, params, jnp.asarray(iq[:, i * N:(i + 1) * N]))
            seq_audio.append(np.asarray(oa["audio"]))
            seq_sm.append(np.asarray(oa["smeter"]["snr_db"]))

        sb = rx.init_state()
        blocks = jnp.asarray(iq.reshape(1, nb, N).transpose(1, 0, 2))  # [K,C,N]
        sb, ob = rx.step_many(sb, params, blocks)
        np.testing.assert_allclose(np.asarray(ob["audio"]),
                                   np.stack(seq_audio), atol=1e-6)
        # dB of a ~1e-12 relative noise power: fusion-order rounding inside
        # the scan body moves it by a few hundredths of a dB
        np.testing.assert_allclose(np.asarray(ob["smeter"]["snr_db"]),
                                   np.stack(seq_sm), atol=0.2)
        # final carry states agree
        for a, b in zip(jax.tree.leaves(sa), jax.tree.leaves(sb)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


class TestWFMHighQuality:
    def test_hq_composite_separation(self):
        """wfm_hq=True restores the reference's ~512k composite geometry:
        stereo separation must clear 40 dB (vs ~35 dB at the default 256k
        Carson-band geometry)."""
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.FMS, wfm_hq=True)
        rx = Receiver(cfg)
        assert rx.demod_rate == 512000
        nb = 24
        iq = TestWFMChain._composite_iq(TestWFMChain(), nb)
        audio, out, _ = run_chain(rx, iq, rx.default_params(300_000.0), nb)
        assert bool(np.asarray(out["pilot_locked"])[0])
        l = audio[0, 0, -6 * rx.audio_blk:]
        r = audio[0, 1, -6 * rx.audio_blk:]
        l1k, _ = tone_fit(l, 1000.0, 48000.0)
        r1k, _ = tone_fit(r, 1000.0, 48000.0)
        r3k, _ = tone_fit(r, 3000.0, 48000.0)
        l3k, _ = tone_fit(l, 3000.0, 48000.0)
        assert 20 * np.log10(l1k / max(r1k, 1e-9)) > 40
        assert 20 * np.log10(r3k / max(l3k, 1e-9)) > 40


def test_channel_count_mismatch_raises():
    """A block whose channel count disagrees with cfg.channels must raise —
    it used to broadcast silently (all channels reading channel 0's NCO
    tables)."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu.demod.modes import DemodMode

    rx = Receiver(ReceiverConfig(sample_rate=512_000, frames_per_buffer=8192,
                                 channels=1, mode=DemodMode.AM))
    state = rx.init_state()
    params = rx.default_params(0.0)
    bad = jnp.zeros((4, 8192), jnp.complex64)
    with pytest.raises(ValueError, match="channels"):
        rx.step(state, params, bad)
    with pytest.raises(ValueError, match="channels"):
        rx.step_many(state, params, jnp.zeros((2, 4, 8192), jnp.complex64))
    # packed-plane layout with a wrong lane width
    with pytest.raises(ValueError, match="channels"):
        rx.step(state, params, jnp.zeros((8192, 8), jnp.float32))
    # 3-dim [K, N, 2C'] planes with a wrong width must raise
    with pytest.raises(ValueError, match="channels"):
        rx.step_many(state, params, jnp.zeros((2, 8192, 8), jnp.float32))
