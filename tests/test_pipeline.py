"""Stage pipelining (PP, SURVEY §2.6): the ring pipeline must equal the
sequential composition of its stages bit-for-bit, including carried state
across run() calls, on the forced 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode
from pebblesdr_tpu.parallel import pipeline

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 devices")

FS = 512_000
N = 8192
C = 2


def _rx():
    return Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                   channels=C, mode=DemodMode.AM))


def _blocks(t_blocks, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(t_blocks * N) / FS
    env = (1 + 0.5 * np.cos(2 * np.pi * 800.0 * t)) / 2
    iq = (env * np.exp(2j * np.pi * 100_000.0 * t)
          + 0.01 * (rng.normal(size=t_blocks * N)
                    + 1j * rng.normal(size=t_blocks * N))).astype(np.complex64)
    blocks = iq.reshape(t_blocks, N)
    # packed [T, 2C, N] float32 planes, both channels the same capture
    return np.stack([
        np.concatenate([np.broadcast_to(b.real, (C, N)),
                        np.broadcast_to(b.imag, (C, N))], 0)
        for b in blocks]).astype(np.float32)


def _sequential(stages, states, xs):
    """Ground truth: run the same stage fns back-to-back on one device."""
    states = list(states)
    ys = []
    for xb in xs:
        b = jnp.asarray(xb)
        for i, st in enumerate(stages):
            states[i], b = st.fn(states[i], b)
        ys.append(np.asarray(b))
    return tuple(states), np.stack(ys)


class TestRingPipeline:
    def test_matches_sequential(self):
        rx = _rx()
        params = rx.default_params(100_000.0)
        stages, init = pipeline.am_chain_stages(rx, params)
        mesh = pipeline.stage_mesh(len(stages))
        pipe = pipeline.RingPipeline(stages, mesh)

        xs = _blocks(6)
        ref_states, ref_ys = _sequential(stages, init, xs)

        _, init2 = pipeline.am_chain_stages(rx, params)
        new_states, ys = pipe.run(init2, jnp.asarray(xs))

        assert ys.shape == (6, C, rx.audio_blk)
        np.testing.assert_allclose(np.asarray(ys), ref_ys, rtol=0, atol=1e-6)
        for a, b in zip(jax.tree.leaves(new_states),
                        jax.tree.leaves(ref_states)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-6)

    def test_streaming_across_runs(self):
        rx = _rx()
        params = rx.default_params(100_000.0)
        stages, init = pipeline.am_chain_stages(rx, params)
        mesh = pipeline.stage_mesh(len(stages))
        pipe = pipeline.RingPipeline(stages, mesh)

        xs = _blocks(4)
        # one 4-block run vs two 2-block runs: carried state must compose
        _, init_a = pipeline.am_chain_stages(rx, params)
        _, ys_once = pipe.run(init_a, jnp.asarray(xs))

        _, init_b = pipeline.am_chain_stages(rx, params)
        st, ys1 = pipe.run(init_b, jnp.asarray(xs[:2]))
        _, ys2 = pipe.run(st, jnp.asarray(xs[2:]))
        np.testing.assert_allclose(
            np.asarray(ys_once),
            np.concatenate([np.asarray(ys1), np.asarray(ys2)]),
            rtol=0, atol=1e-6)

    def test_matches_receiver_step(self):
        """Pipelined audio must match the MONOLITHIC Receiver.step (not just
        the stage-fn composition): catches any stage fn drifting from the
        chain it claims to split (advisor round-1 high finding)."""
        rx = _rx()
        params = rx.default_params(100_000.0)
        stages, init = pipeline.am_chain_stages(rx, params)
        mesh = pipeline.stage_mesh(len(stages))
        pipe = pipeline.RingPipeline(stages, mesh)

        xs = _blocks(5)
        new_states, ys = pipe.run(init, jnp.asarray(xs))

        st = rx.init_state()
        ref = []
        for xb in xs:  # [2C, N] packed stage payload -> [C, N] complex64
            iq = (xb[:C] + 1j * xb[C:]).astype(np.complex64)
            st, out = rx.step(st, params, jnp.asarray(iq), spectra=False)
            ref.append(np.asarray(out["audio"]))
        np.testing.assert_allclose(np.asarray(ys), np.stack(ref),
                                   rtol=0, atol=1e-5)

    def test_stage_state_is_receiver_layout(self):
        """The stage fns carry the Receiver's own front-end state: the
        decim stage's initial carry is the composed [C, D] history."""
        rx = _rx()
        _, init = pipeline.am_chain_stages(rx, rx.default_params(0.0))
        base = rx.init_state()
        assert init[1].shape == base.decim.shape == (C, base.decim.shape[1])
        assert init[0][0].shape == base.dc.shape

    def test_mesh_size_validation(self):
        rx = _rx()
        params = rx.default_params(0.0)
        stages, _ = pipeline.am_chain_stages(rx, params)
        with pytest.raises(ValueError, match="one per stage"):
            pipeline.RingPipeline(stages, pipeline.stage_mesh(2))
