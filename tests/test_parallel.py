"""Sharding correctness on the forced 8-device CPU mesh: time-sharded kernels
with ppermute halo exchange must be bit-close to the unsharded stream ops."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pebblesdr_tpu.ops import decimator, fastfir, fir, mixer
from pebblesdr_tpu.parallel import mesh as mesh_mod
from pebblesdr_tpu.parallel import time_shard

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _mesh_time(n=8):
    return mesh_mod.make_mesh(channel=1, time=n)


class TestShardedFir:
    def test_matches_unsharded_streaming(self):
        m = _mesh_time()
        taps = np.asarray(fir.design_halfband(23, 0.182), np.float32)
        rng = np.random.default_rng(0)
        c, n = 2, 8192
        blocks = [
            (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n))).astype(np.complex64)
            for _ in range(3)]

        # unsharded reference
        tail = fir.fir_tail_init(c, len(taps))
        ref = []
        for b in blocks:
            y, tail = fir.fir_apply(jnp.asarray(b), jnp.asarray(taps), tail, 2)
            ref.append(np.asarray(y))

        # time-sharded version
        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=m,
            in_specs=(P("channel", "time"), P(), P()),
            out_specs=(P("channel", "time"), P()),
            check_vma=False)
        def sharded(x, taps_, carry):
            y, nc = time_shard.sharded_fir_decimate(x, taps_, carry, 2, "time")
            return y, nc

        carry = fir.fir_tail_init(c, len(taps))
        for i, b in enumerate(blocks):
            y, carry = sharded(jnp.asarray(b), jnp.asarray(taps), carry)
            np.testing.assert_allclose(np.asarray(y), ref[i], atol=1e-5)


class TestShardedDecimatorChain:
    def test_cascade_matches(self):
        m = _mesh_time()
        plan = decimator.build_plan(1_024_000, 20_000)
        rng = np.random.default_rng(1)
        c, n = 1, 1 << 14
        x = (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n))).astype(np.complex64)

        st = decimator.state_init(plan, c)
        _, ref = decimator.apply(plan, st, jnp.asarray(x))

        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=m,
            in_specs=(P("channel", "time"),
                      tuple(P() for _ in plan.stages)),
            out_specs=(P("channel", "time"), tuple(P() for _ in plan.stages)),
            check_vma=False)
        def sharded(xl, carries):
            nc, y = time_shard.sharded_decimator_apply(plan, carries, xl, "time")
            return y, nc

        carries = decimator.state_init(plan, c)
        y, _ = sharded(jnp.asarray(x), carries)
        np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=1e-5)


class TestShardedMixer:
    def test_matches_unsharded(self):
        m = _mesh_time()
        c, n = 2, 8192
        fs, f = 1_024_000.0, 123_456.0
        hi, lo = mixer.split_freq(f, fs)
        rng = np.random.default_rng(2)
        x = (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n))).astype(np.complex64)

        st = mixer.mixer_init(c)
        st2, ref = mixer.mix(st, jnp.asarray(x), hi, lo)

        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=m,
            in_specs=(P(), P("channel", "time"), P(), P()),
            out_specs=(P(), P("channel", "time")),
            check_vma=False)
        def sharded(phase0, xl, hi_, lo_):
            return time_shard.sharded_mix(phase0, xl, hi_, lo_, "time")

        new_phase, y = sharded(st.phase, jnp.asarray(x), hi, lo)
        np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=2e-3)
        np.testing.assert_allclose(np.asarray(new_phase), np.asarray(st2.phase),
                                   atol=1e-4)


class TestShardedOverlapSave:
    def test_matches_unsharded(self):
        m = _mesh_time()
        c = 1
        blk_local = 512
        n = 8 * blk_local
        fs = 16000.0
        mask = jnp.asarray(fastfir.design_mask(-3000.0, 3000.0, fs, blk_local))
        rng = np.random.default_rng(3)
        x = (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n))).astype(np.complex64)

        # unsharded: 8 sequential overlap-save rounds of blk_local
        st = fastfir.state_init(c, blk_local)
        ref = []
        for i in range(8):
            st, y = fastfir.apply(st, jnp.asarray(x[:, i * blk_local:(i + 1) * blk_local]), mask)
            ref.append(np.asarray(y))
        ref = np.concatenate(ref, axis=1)

        @jax.jit
        @functools.partial(
            jax.shard_map, mesh=m,
            in_specs=(P(), P("channel", "time"), P()),
            out_specs=(P(), P("channel", "time")),
            check_vma=False)
        def sharded(state, xl, mask_):
            return time_shard.sharded_overlap_save(state, xl, mask_, "time")

        st0 = fastfir.state_init(c, blk_local)
        new_state, y = sharded(st0, jnp.asarray(x), mask)
        np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4)
        np.testing.assert_allclose(np.asarray(new_state),
                                   x[:, -blk_local:], atol=1e-6)


class TestChannelSharding:
    def test_chain_step_channel_parallel(self):
        """Full Receiver step jit-compiled with channel sharding over the mesh
        executes and matches the unsharded result."""
        from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu.demod.modes import DemodMode

        m = mesh_mod.make_mesh(channel=8, time=1)
        fs, n = 512_000, 8192
        cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=n, channels=8,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        t = np.arange(n) / fs
        iq = np.broadcast_to(
            ((1 + 0.5 * np.cos(2 * np.pi * 400 * t)) / 2
             * np.exp(2j * np.pi * 100_000 * t)).astype(np.complex64), (8, n)).copy()
        params = rx.default_params(100_000.0)

        state = rx.init_state()
        state_ref, out_ref = rx.step(state, params, jnp.asarray(iq))

        state2 = mesh_mod.shard_state(rx.init_state(), m)
        iq_sharded = jax.device_put(jnp.asarray(iq), mesh_mod.channel_sharding(m))
        state_sh, out_sh = rx.step(state2, params, iq_sharded)
        np.testing.assert_allclose(np.asarray(out_sh["audio"]),
                                   np.asarray(out_ref["audio"]), atol=1e-5)


class TestShardedStepParity:
    def test_matches_unsharded(self):
        """channelizer.build_sharded_step (time-shard halo front end +
        channel-sharded tail) must match the plain Receiver step."""
        from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu.demod.modes import DemodMode
        from pebblesdr_tpu.parallel import channelizer

        m = mesh_mod.make_mesh(channel=4, time=2)
        fs, n, c = 512_000, 8192, 8
        cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=n, channels=c,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        t = np.arange(2 * n) / fs
        tones = np.linspace(-150_000, 150_000, c)
        capture = sum(0.2 * np.exp(2j * np.pi * (f + 400.0) * t) for f in tones)
        iq = np.broadcast_to(capture.astype(np.complex64), (c, 2 * n)).copy()
        params = rx.default_params(tones)

        state_ref = rx.init_state()
        ref = []
        for i in range(2):
            state_ref, out = rx.step(state_ref, params,
                                     jnp.asarray(iq[:, i * n:(i + 1) * n]))
            ref.append(np.asarray(out["audio"]))

        step = channelizer.build_sharded_step(rx, m)
        state_sh = mesh_mod.shard_state(rx.init_state(), m)
        got = []
        for i in range(2):
            blk = jax.device_put(jnp.asarray(iq[:, i * n:(i + 1) * n]),
                                 mesh_mod.block_sharding(m))
            state_sh, audio = step(state_sh, params, blk)
            got.append(np.asarray(audio))
        np.testing.assert_allclose(np.concatenate(got, -1),
                                   np.concatenate(ref, -1), atol=2e-3)


class TestShardedFrontDcOffset:
    def test_dc_offset_time4_matches_unsharded(self):
        """A capture with a DC offset on a (channel=2, time=4) mesh: the
        sharded front's cross-shard DC-blocker seeding and one-halo
        composed FIR must match the plain single-device Receiver over
        three streamed blocks."""
        from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu.demod.modes import DemodMode
        from pebblesdr_tpu.parallel import channelizer

        m = mesh_mod.make_mesh(channel=2, time=4)
        fs, n, c = 512_000, 8192, 4
        cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=n, channels=c,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg)
        nb = 3
        t = np.arange(nb * n) / fs
        tones = np.linspace(-150_000, 150_000, c)
        capture = sum(0.2 * np.exp(2j * np.pi * (f + 400.0) * t) for f in tones)
        capture = capture + 0.03  # deliberate DC offset
        iq = np.broadcast_to(capture.astype(np.complex64), (c, nb * n)).copy()
        params = rx.default_params(tones)

        state_ref = rx.init_state()
        ref = []
        for i in range(nb):
            state_ref, out = rx.step(state_ref, params,
                                     jnp.asarray(iq[:, i * n:(i + 1) * n]))
            ref.append(np.asarray(out["audio"]))

        step = channelizer.build_sharded_step(rx, m)
        state_sh = mesh_mod.shard_state(rx.init_state(), m)
        got = []
        for i in range(nb):
            blk = jax.device_put(jnp.asarray(iq[:, i * n:(i + 1) * n]),
                                 mesh_mod.block_sharding(m))
            state_sh, audio = step(state_sh, params, blk)
            got.append(np.asarray(audio))
        np.testing.assert_allclose(np.concatenate(got, -1),
                                   np.concatenate(ref, -1), atol=2e-3)
        # the carried front state is the single-device layout, and agrees
        np.testing.assert_allclose(np.asarray(state_sh.decim),
                                   np.asarray(state_ref.decim), atol=1e-4)
        np.testing.assert_allclose(np.asarray(state_sh.dc),
                                   np.asarray(state_ref.dc), atol=1e-6)


class TestShardedWfmStep:
    def test_wfm_sharded_matches_unsharded(self):
        """Sharded channelizer step for WFM-stereo (time-shard front end +
        channel-sharded composite path) matches the plain Receiver."""
        from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu.demod.modes import DemodMode
        from pebblesdr_tpu.parallel import channelizer

        m = mesh_mod.make_mesh(channel=4, time=2)
        fs, n, c = 2_048_000, 32768, 4
        cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=n, channels=c,
                             mode=DemodMode.FMS)
        rx = Receiver(cfg)
        nb = 4
        t = np.arange(nb * n) / fs
        comp = (0.45 * np.sin(2 * np.pi * 1000.0 * t)
                + 0.1 * np.sin(2 * np.pi * 19000.0 * t))
        ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
        iq = np.broadcast_to(
            (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + ph))
             ).astype(np.complex64), (c, nb * n)).copy()
        params = rx.default_params(300_000.0)

        state_ref = rx.init_state()
        ref = []
        for i in range(nb):
            state_ref, out = rx.step(state_ref, params,
                                     jnp.asarray(iq[:, i * n:(i + 1) * n]))
            ref.append(np.asarray(out["audio"]))

        step = channelizer.build_sharded_step(rx, m)
        state_sh = mesh_mod.shard_state(rx.init_state(), m)
        got = []
        for i in range(nb):
            blk = jax.device_put(jnp.asarray(iq[:, i * n:(i + 1) * n]),
                                 mesh_mod.block_sharding(m))
            state_sh, audio = step(state_sh, params, blk)
            got.append(np.asarray(audio))
        np.testing.assert_allclose(np.concatenate(got, -1),
                                   np.concatenate(ref, -1), atol=3e-3)
