"""Stream recovery (SURVEY §5 failure detection/recovery): dropped-block
resync bounds the audio disturbance and restores phase coherence; periodic
checkpoints make a killed stream resume bit-exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode
from pebblesdr_tpu.utils import recovery

FS = 512_000
N = 8192
F0 = 250_013.0  # per-block mixer phase advance deliberately non-integer


def _rx():
    return Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                   channels=1, mode=DemodMode.USB,
                                   agc_mode="off"))


def _blocks(n_blocks):
    t = np.arange(n_blocks * N) / FS
    iq = (0.5 * np.exp(2j * np.pi * (F0 + 1000.0) * t)).astype(np.complex64)
    return [iq[None, i * N:(i + 1) * N] for i in range(n_blocks)]


def _run(rx, params, blocks, seqs, supervisor=None):
    state = rx.init_state()
    audio = {}
    for seq, blk in zip(seqs, blocks):
        if supervisor is not None:
            state = supervisor.observe(state, seq)
        state, out = rx.step(state, params, jnp.asarray(blk), spectra=False)
        if supervisor is not None:
            supervisor.block_done(state)
        audio[seq] = np.asarray(out["audio"])[0]
    return state, audio


class TestGapResync:
    def test_phase_coherent_after_gap(self):
        """Drop 3 blocks mid-stream: with resync the post-gap audio matches
        the uninterrupted run (phase-coherent USB tone) after a bounded
        transient; without resync it stays phase-rotated forever."""
        rx = _rx()
        params = rx.default_params(F0)
        n_blocks = 20
        blocks = _blocks(n_blocks)
        _, ref = _run(rx, params, blocks, range(n_blocks))

        keep = [s for s in range(n_blocks) if not 10 <= s <= 12]
        sup = recovery.StreamSupervisor(rx, params)
        _, got = _run(rx, params, [blocks[s] for s in keep], keep,
                      supervisor=sup)

        assert sup.monitor.dropped_blocks == 3
        kinds = [e.kind for e in sup.events]
        assert "gap" in kinds
        # bounded disturbance: by two blocks after the gap every stale tail
        # has flushed and the audio matches the uninterrupted run
        for s in (15, 16, 19):
            np.testing.assert_allclose(got[s], ref[s], atol=2e-4)
        # the pre-gap stream is untouched
        np.testing.assert_allclose(got[9], ref[9], atol=1e-6)

        # control: WITHOUT resync the tone comes back phase-rotated
        _, bad = _run(rx, params, [blocks[s] for s in keep], keep,
                      supervisor=None)
        err = np.max(np.abs(bad[19] - ref[19]))
        assert err > 0.05, err  # ~0.62 cycle offset → gross mismatch

    def test_report_structure(self):
        rx = _rx()
        params = rx.default_params(F0)
        sup = recovery.StreamSupervisor(rx, params)
        blocks = _blocks(6)
        keep = [0, 1, 4, 5]
        _run(rx, params, [blocks[s] for s in keep], keep, supervisor=sup)
        rep = sup.report()
        assert rep["dropped_blocks"] == 2
        gap_events = [e for e in rep["events"] if e["kind"] == "gap"]
        assert gap_events and gap_events[0]["gap_blocks"] == 2


class TestKillAndResume:
    def test_resume_bit_exact(self, tmp_path):
        """Checkpoint every 4 blocks, 'crash' after block 10, restore into a
        FRESH receiver, replay from the checkpointed sequence: outputs are
        bit-identical to the uninterrupted run."""
        rx = _rx()
        params = rx.default_params(F0)
        n_blocks = 14
        blocks = _blocks(n_blocks)
        _, ref = _run(rx, params, blocks, range(n_blocks))

        path = str(tmp_path / "chain.npz")
        sup = recovery.StreamSupervisor(rx, params, checkpoint_path=path,
                                        checkpoint_every=4)
        state = rx.init_state()
        for seq in range(10):  # crash after block 9 (last checkpoint: seq 8)
            state = sup.observe(state, seq)
            state, _ = rx.step(state, params, jnp.asarray(blocks[seq]),
                               spectra=False)
            sup.block_done(state)
        assert any(e.kind == "checkpoint" for e in sup.events)

        # fresh process: new receiver + supervisor, restore, continue
        rx2 = _rx()
        sup2 = recovery.StreamSupervisor(rx2, params, checkpoint_path=path,
                                         checkpoint_every=4)
        state2, meta = sup2.restore(rx2.init_state())
        resume_seq = meta["seq"]
        assert resume_seq == 8
        for seq in range(resume_seq, n_blocks):
            state2 = sup2.observe(state2, seq)
            state2, out = rx2.step(state2, params, jnp.asarray(blocks[seq]),
                                   spectra=False)
            sup2.block_done(state2)
            np.testing.assert_array_equal(np.asarray(out["audio"])[0],
                                          ref[seq])

    def test_resume_bit_exact_round4_states(self, tmp_path):
        """Round-4 carry state (front NB avg/spike-tail, CTCSS coherent
        EWMA, ANF weights, RDS premix twiddle phase) must checkpoint/resume
        bit-exactly mid-stream."""
        from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu.demod.modes import DemodMode
        from pebblesdr_tpu.utils import checkpoint as ckpt

        fs, n = 2_048_000, 32768
        cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                             channels=2, mode=DemodMode.FMN,
                             enable_noise_blanker=True, enable_anf=True,
                             ctcss_tone=123.0)
        rx = Receiver(cfg)
        params = rx.default_params(300_000.0)
        t = np.arange(8 * n) / fs
        dev = 2500.0 * np.sin(2 * np.pi * 1000.0 * t) \
            + 500.0 * np.sin(2 * np.pi * 123.0 * t)
        ph = 2 * np.pi * np.cumsum(dev) / fs
        iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + ph))
              ).astype(np.complex64)
        iq[5000::100000] += 8.0 + 8.0j
        iq2 = iq[None, :] * np.ones((2, 1), np.float32)

        st = rx.init_state()
        outs = []
        for b in range(8):
            if b == 4:
                path = str(tmp_path / "mid.npz")
                ckpt.save_state(path, st)
            st, o = rx.step(st, params, jnp.asarray(iq2[:, b*n:(b+1)*n]),
                            spectra=False)
            outs.append(np.asarray(o["audio"]))

        st2, _ = ckpt.load_state(path, rx.init_state())
        for b in range(4, 8):
            st2, o2 = rx.step(st2, params, jnp.asarray(iq2[:, b*n:(b+1)*n]),
                              spectra=False)
            np.testing.assert_array_equal(np.asarray(o2["audio"]), outs[b])

        # and the RDS premix twiddle phase (FMS + rds)
        cfg_w = ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                               channels=1, mode=DemodMode.FMS, rds=True)
        rxw = Receiver(cfg_w)
        pw = rxw.default_params(300_000.0)
        comp = 0.3 * np.sin(2 * np.pi * 1000.0 * t) \
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
        phw = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
        iqw = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phw))
               ).astype(np.complex64)[None]
        stw = rxw.init_state()
        outs_w = []
        for b in range(6):
            if b == 3:
                pathw = str(tmp_path / "wfm.npz")
                ckpt.save_state(pathw, stw)
            stw, ow = rxw.step(stw, pw, jnp.asarray(iqw[:, b*n:(b+1)*n]),
                               spectra=False)
            outs_w.append(np.asarray(ow["rds_soft"]))
        stw2, _ = ckpt.load_state(pathw, rxw.init_state())
        for b in range(3, 6):
            stw2, ow2 = rxw.step(stw2, pw, jnp.asarray(iqw[:, b*n:(b+1)*n]),
                                 spectra=False)
            np.testing.assert_array_equal(np.asarray(ow2["rds_soft"]),
                                          outs_w[b])
