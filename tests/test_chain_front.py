"""The Receiver's front end through the chain: the batched step_many graph
(one front-end pass over the whole dispatch) must match K per-block step()
calls, with the noise blanker and IQ balance on."""

import numpy as np
import jax.numpy as jnp

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode

FS, N, C = 1_024_000, 16384, 8


def _run(rx, params, iq, batched):
    """Audio [C, 4*audio_blk] from four step() calls or ONE step_many."""
    state = rx.init_state()
    if batched:
        blocks = jnp.asarray(np.moveaxis(iq.reshape(C, 4, N), 1, 0))
        _, out = rx.step_many(state, params, blocks)
        return np.concatenate(list(np.asarray(out["audio"])), axis=-1)
    outs = []
    for i in range(4):
        state, out = rx.step(state, params,
                             jnp.asarray(iq[:, i * N:(i + 1) * N]))
        outs.append(np.asarray(out["audio"]))
    return np.concatenate(outs, axis=-1)


class TestBatchedFrontParity:
    def test_am_chain_matches(self):
        t = np.arange(4 * N) / FS
        iq = np.broadcast_to(
            ((1 + 0.7 * np.cos(2 * np.pi * 800 * t)) / 2
             * np.exp(2j * np.pi * 200_000 * t)).astype(np.complex64),
            (C, 4 * N)).copy()
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             channels=C, mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        assert rx.batched_capable
        params = rx.default_params(200_000.0)
        np.testing.assert_allclose(_run(rx, params, iq, True),
                                   _run(rx, params, iq, False), atol=2e-4)

    def test_nb_iqbal_batched_matches(self):
        """The noise blanker and static IQ balance run inside the batched
        front: step_many == per-block step(), and spikes are blanked."""
        t = np.arange(4 * N) / FS
        iq = np.broadcast_to(
            ((1 + 0.7 * np.cos(2 * np.pi * 800 * t)) / 2
             * np.exp(2j * np.pi * 200_000 * t)).astype(np.complex64),
            (C, 4 * N)).copy()
        rng = np.random.default_rng(3)
        spikes = rng.choice(4 * N, 40, replace=False)
        iq[:, spikes] += 12.0 - 12.0j

        import dataclasses
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             channels=C, mode=DemodMode.AM,
                             agc_mode="off", enable_noise_blanker=True,
                             enable_iq_balance=True)
        rx = Receiver(cfg)
        assert rx.batched_capable  # NB and IQ balance keep the batched graph
        params = dataclasses.replace(
            rx.default_params(200_000.0),
            iq_gain=jnp.asarray(1.04, jnp.float32),
            iq_phase=jnp.asarray(0.015, jnp.float32))
        np.testing.assert_allclose(_run(rx, params, iq, True),
                                   _run(rx, params, iq, False), atol=2e-4)
        # and the blanker worked: with NB on (alone — the IQ-balance gain
        # intentionally scales the audio, so it must stay out of this
        # comparison), the audio is much closer to the CLEAN (spike-free)
        # chain output than a NB-off run is
        iq_clean = np.broadcast_to(
            ((1 + 0.7 * np.cos(2 * np.pi * 800 * t)) / 2
             * np.exp(2j * np.pi * 200_000 * t)).astype(np.complex64),
            (C, 4 * N)).copy()
        res = {}
        for name, nb_on, sig in (("clean", False, iq_clean),
                                 ("spiky", False, iq),
                                 ("nb", True, iq)):
            cfg2 = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                  channels=C, mode=DemodMode.AM,
                                  agc_mode="off",
                                  enable_noise_blanker=nb_on)
            rx = Receiver(cfg2)
            params = rx.default_params(200_000.0)
            state = rx.init_state()
            outs = []
            for i in range(4):
                state, out = rx.step(state, params,
                                     jnp.asarray(sig[:, i * N:(i + 1) * N]))
                outs.append(np.asarray(out["audio"]))
            res[name] = np.concatenate(outs, axis=-1)
        # skip block 0: the blanker's magnitude average initializes at zero,
        # so its first chunk blanks until the average learns (startup only)
        m = res["nb"].shape[-1] // 4
        err_nb = np.sqrt(np.mean((res["nb"][:, m:]
                                  - res["clean"][:, m:]) ** 2))
        err_off = np.sqrt(np.mean((res["spiky"][:, m:]
                                   - res["clean"][:, m:]) ** 2))
        assert err_nb < 0.5 * err_off, (err_nb, err_off)


class TestNbWithWfm:
    def test_wfm_stereo_nb_batched_matches_sequential(self):
        """NB in the front of the batched WFM-stereo graph: batched
        step_many == K sequential steps, NB-on, stereo."""
        import functools

        import jax

        t = np.arange(3 * N) / FS
        a = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
        th = 2 * np.pi * 19000.0 * t
        comp = 0.45 * a + 0.1 * np.sin(th) + 0.45 * a * np.sin(2 * th)
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        iq = (0.5 * np.exp(1j * (2 * np.pi * 200_000.0 * t + phase))
              ).astype(np.complex64)
        rng = np.random.default_rng(4)
        iq[rng.choice(3 * N, 25, replace=False)] += 10.0 + 10.0j
        iq = iq[None, :] * np.ones((2, 1), np.float32)
        x_pk = np.concatenate([iq.real.astype(np.float32).T,
                               iq.imag.astype(np.float32).T], axis=1)

        from pebblesdr_tpu.demod.modes import DemodMode as DM
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=2,
                             mode=DM.FMS, enable_noise_blanker=True)
        rx = Receiver(cfg)
        assert rx.batched_capable
        params = rx.default_params(200_000.0)

        st = rx.init_state()
        step = jax.jit(functools.partial(rx._step_impl, spectra=False))
        seq = []
        for k in range(3):
            st, o = step(st, params, jnp.asarray(x_pk[k * N:(k + 1) * N]))
            seq.append(np.asarray(o["audio"]))
        audio_seq = np.concatenate(seq, axis=-1)

        st2 = rx.init_state()
        st2, ob = jax.jit(functools.partial(rx._step_many_impl,
                                            spectra=False))(
            st2, params, jnp.asarray(x_pk))
        audio_b = np.moveaxis(np.asarray(ob["audio"]), 0, -2).reshape(
            audio_seq.shape)
        scale = max(np.abs(audio_seq).max(), 1e-6)
        assert np.abs(audio_seq - audio_b).max() / scale < 2e-3


class TestWfmTail:
    def test_non_pow2_audio_decim_runs(self):
        """audio_decim=6 (1.536 Msps -> 384 kHz composite): a
        non-power-of-two audio decimation must build and run."""
        fs2, frames = 1_536_000, 24576
        cfg = ReceiverConfig(sample_rate=fs2, frames_per_buffer=frames,
                             channels=2, mode=DemodMode.FMS)
        rx = Receiver(cfg)
        assert rx.wfm_cfg.audio_decim == 6
        state = rx.init_state()
        params = rx.default_params(200_000.0)
        iq = np.zeros((2, frames), np.complex64)
        state, out = rx.step(state, params, jnp.asarray(iq))
        assert out["audio"].shape[0] == 2
