"""Stage pipelining (PP analog, SURVEY §2.6): chain stages on a device ring.

The reference's only concurrency is pipeline parallelism between Qt threads
(device producer -> consumer chain -> audio output; pebblelib/producerconsumer.h:18-96).
This module is its device-mesh generalization: the receive chain is split into
S stages, stage s lives on device s of a ``stage`` mesh axis, and every tick
each device runs its stage on the block it holds, then hands the result to
its right neighbour with ONE ``lax.ppermute`` (the double-buffered
collective-permute of SURVEY §2.6's PP row).  After S-1 warmup ticks the ring
is full: all S devices compute different blocks of the stream concurrently,
and one finished block leaves the last device per tick — latency hiding for
chains whose stages are individually too small to fill a chip.

SPMD mechanics: one program runs on all devices; ``lax.switch`` on
``axis_index`` selects the device's stage.  Inter-stage payloads ride one
fixed [rows, width] float32 buffer (each stage unpads its input and pads its
output), because a ppermute needs one static shape.  Per-stage carry state is
replicated but only the owning device's copy advances (the others are masked
off with the warmup/flush validity gate); ``RingPipeline.run`` returns the
de-replicated states so back-to-back runs are streaming-exact.

Validated on the forced 8-device CPU mesh (tests/test_pipeline.py): pipelined
output == sequential composition bit-for-bit, including carried state across
run() calls.  On real hardware the win appears when S chips each hold one
stage of a chain too deep for one card's memory working set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: ``fn(state, x) -> (state', y)`` with x float32
    [in_shape], y float32 [out_shape].  fn must preserve the state pytree
    structure (it is carried through a lax.scan)."""
    fn: Callable[[Any, jax.Array], tuple[Any, jax.Array]]
    in_shape: tuple[int, int]
    out_shape: tuple[int, int]


def stage_mesh(n: int, devices=None) -> Mesh:
    devices = list(jax.devices()) if devices is None else list(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]), ("stage",))


class RingPipeline:
    """S-stage ring over the ``stage`` axis of ``mesh``.

    run(states, xs): xs [T, *stages[0].in_shape] -> (states',
    ys [T, *stages[-1].out_shape]).  Internally scans T + S - 1 ticks (the
    ring drains at the end of every run, so runs compose streaming-exactly);
    block b's result emerges at tick b + S - 1.
    """

    def __init__(self, stages: list[Stage], mesh: Mesh,
                 axis: str = "stage"):
        self.stages = list(stages)
        self.mesh = mesh
        self.axis = axis
        s = len(self.stages)
        if mesh.shape[axis] != s:
            raise ValueError(f"mesh axis '{axis}' has {mesh.shape[axis]} "
                             f"devices, need one per stage ({s})")
        self.rows = max(max(st.in_shape[0], st.out_shape[0])
                        for st in self.stages)
        self.width = max(max(st.in_shape[1], st.out_shape[1])
                         for st in self.stages)
        self._jitted: dict[int, Callable] = {}

    # ------------------------------------------------------------------ build
    def _build(self, t_blocks: int):
        s = len(self.stages)
        rows, width = self.rows, self.width
        axis = self.axis
        stages = self.stages

        def make_branch(i: int):
            st_i = stages[i]

            def branch(states, b):
                x = b[:st_i.in_shape[0], :st_i.in_shape[1]]
                new_i, y = st_i.fn(states[i], x)
                y_pad = jnp.zeros((rows, width), jnp.float32)
                y_pad = y_pad.at[:st_i.out_shape[0], :st_i.out_shape[1]].set(y)
                return (tuple(new_i if j == i else states[j]
                              for j in range(s)), y_pad)

            return branch

        branches = [make_branch(i) for i in range(s)]

        def device_body(states, xs_pad):
            idx = lax.axis_index(axis)

            def tick(carry, inp):
                st, buf = carry
                t, x_t = inp
                b = jnp.where(idx == 0, x_t, buf)
                new_st, y = lax.switch(idx, branches, st, b)
                # warmup/flush gate: device idx holds block t - idx; its
                # state only advances while that block is real
                valid = (t >= idx) & (t - idx < t_blocks)
                st = jax.tree.map(lambda n, o: jnp.where(valid, n, o),
                                  new_st, st)
                out = lax.psum(jnp.where(idx == s - 1, y, 0.0), axis)
                shifted = lax.ppermute(y, axis,
                                       [(d, d + 1) for d in range(s - 1)])
                return (st, shifted), out

            buf0 = jnp.zeros((rows, width), jnp.float32)
            ticks = jnp.arange(t_blocks + s - 1)
            (states, _), ys = lax.scan(tick, (states, buf0), (ticks, xs_pad))
            # gather every device's replica of every stage state; the host
            # keeps the diagonal (device i's copy of stage i)
            stacked = jax.tree.map(lambda a: a[None], states)
            return stacked, ys[s - 1:]

        shard = jax.shard_map(
            device_body, mesh=self.mesh,
            in_specs=(P(), P()),
            out_specs=(P(axis), P()),
            check_vma=False)

        @jax.jit
        def run(states, xs):
            t = xs.shape[0]
            xs_pad = jnp.zeros((t + s - 1, rows, width), jnp.float32)
            xs_pad = xs_pad.at[:t, :xs.shape[1], :xs.shape[2]].set(xs)
            stacked, ys = shard(tuple(states), xs_pad)
            out_r, out_w = stages[-1].out_shape
            return stacked, ys[:, :out_r, :out_w]

        return run

    # -------------------------------------------------------------------- run
    def run(self, states, xs: jax.Array):
        """Process T = xs.shape[0] blocks; returns (states', ys)."""
        t = int(xs.shape[0])
        if t not in self._jitted:
            self._jitted[t] = self._build(t)
        stacked, ys = self._jitted[t](states, xs)
        new_states = tuple(
            jax.tree.map(lambda a, _i=i: a[_i], stacked[i])
            for i in range(len(self.stages)))
        return new_states, ys


# ---------------------------------------------------------------------------
# Receive-chain stage split: the classic 4-deep SDR pipeline
# (front mix -> decimate -> bandpass -> demod/audio), built from the same ops
# as Receiver._step_impl so the pipelined chain is bit-identical to the
# monolithic one.
# ---------------------------------------------------------------------------

def _pack(z: jax.Array) -> jax.Array:
    return jnp.concatenate([jnp.real(z), jnp.imag(z)], axis=0)


def _unpack(b: jax.Array) -> jax.Array:
    c = b.shape[0] // 2
    return lax.complex(b[:c], b[c:])


def am_chain_stages(rx, params) -> tuple[list[Stage], tuple]:
    """Split an AM Receiver's chain into 4 pipeline stages.

    Returns (stages, init_states).  Payload layout: complex [C, n] rides as
    packed [2C, n] float32 planes; the final stage emits real audio [C, blk].

    The stage fns are the Receiver's own front-end ops (dc_removal_chunked /
    mixer.mix / front.decimate_composed) on its own state layout.
    """
    from pebblesdr_tpu.demod import am as am_mod
    from pebblesdr_tpu.ops import (agc, decimator, fastfir, front, iir, mixer,
                                   resampler)

    c = rx.cfg.channels
    n = rx.cfg.frames_per_buffer
    blk = rx.blk
    base = rx.init_state()

    def s_front(state, b):
        dc, mx = state
        x = _unpack(b)
        dc, x = iir.dc_removal_chunked(dc, x, alpha=front.DC_ALPHA)
        mx, x = mixer.mix(mx, x, params.tune_hi, params.tune_lo)
        return (dc, mx), _pack(x)

    h = decimator.compose_response(rx.plan)

    def s_decim(state, b):
        state, x = front.decimate_composed(state, _unpack(b), h,
                                           rx.plan.factor)
        return state, _pack(x)

    def s_bandpass(state, b):
        mask = lax.complex(params.bp_mask[0], params.bp_mask[1])
        state, x = fastfir.apply(state, _unpack(b), mask)
        return state, _pack(x)

    def s_demod(state, b):
        # calls am_demod itself (not a re-spelled copy) so the pipelined
        # demod stage is the SAME computation Receiver._narrowband_path runs
        # — including the chunked DC blocker (chunk=256)
        agc_st, dm, rs = state
        agc_st, x = agc.agc_apply(rx.agc_cfg, agc_st, _unpack(b))
        dm, audio = am_mod.am_demod(rx.am_cfg, dm, x)
        rs, audio = resampler.apply(rx.rs_plan, rs, audio)
        return (agc_st, dm, rs), audio

    stages = [
        Stage(s_front, (2 * c, n), (2 * c, n)),
        Stage(s_decim, (2 * c, n), (2 * c, blk)),
        Stage(s_bandpass, (2 * c, blk), (2 * c, blk)),
        Stage(s_demod, (2 * c, blk), (c, rx.audio_blk)),
    ]
    init = ((base.dc, base.mixer), base.decim, base.fastfir,
            (base.agc, base.demod, base.resamp))
    return stages, init
