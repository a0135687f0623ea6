"""Sharded whole-chain step: one wideband capture -> many demodulated channels
across a (channel x time) device mesh.

This is BASELINE.json config #4/#5: channels shard as a pure map (DP analog);
the wideband front end (DC blocker + NCO mix + composed-FIR decimation) runs
time-sharded under jax.shard_map with explicit ppermute halo exchange (SP/CP
analog, see parallel.time_shard); the decimated narrowband tail of the chain
(FastFIR -> AGC -> demod -> resample) runs channel-sharded.

Streaming-exact vs the single-device Receiver, and on the same state layout:
the DC estimate is [C] complex64 and the decimator carry is the composed
front's [C, D] post-mix history (ops.front), so rx.init_state() serves both.
"""

from __future__ import annotations

import functools

import jax
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverState
from pebblesdr_tpu.demod.modes import is_wfm
from pebblesdr_tpu.ops import decimator, front as front_mod
from pebblesdr_tpu.ops.mixer import MixerState
from pebblesdr_tpu.parallel import time_shard


def build_sharded_step(rx: Receiver, mesh):
    """Returns a jitted step(state, params, iq) for iq [C, N] sharded
    (channel, time) over the mesh; state from rx.init_state().

    The wideband front end (DC blocker + NCO mix + ENTIRE decimator
    cascade) runs time-sharded with ONE ppermute halo of D post-mix samples
    per block; the decimated tail (narrowband FastFIR/AGC/demod or the WFM
    composite path) runs channel-sharded; XLA places the reshard gather."""
    front = _build_front(rx, mesh)
    csh = NamedSharding(mesh, P("channel", None))

    def tail_fn(state: ReceiverState, params, x):
        taps_out = {}
        if is_wfm(rx.cfg.mode):
            out = {}
            (audio, demod_state, resamp_state, agc_state, anf_state,
             ff_state, rds_state) = rx._wfm_path(state, x, taps_out, out)
        else:
            audio, demod_state, resamp_state, agc_state, anf_state, ff_state = (
                rx._narrowband_path(state, params, x, taps_out))
            rds_state = state.rds
        return (audio, demod_state, resamp_state, agc_state, anf_state,
                ff_state, rds_state)

    # The tail is a pure per-channel map, but left to GSPMD it is NOT
    # partitioned that way: XLA's partitioner has no sharded FFT, so the
    # FastFIR overlap-save FFT/IFFT gets ALL-GATHERED to every device and
    # computed redundantly (measured: 6 all-gathers, ~1 MB/block on an
    # 8-way channel mesh — the whole input volume).  Running the tail
    # under shard_map pins every per-channel op to its local shard and
    # makes the channel axis communication-free by construction.
    c_total = rx.cfg.channels

    def _spec_of(leaf):
        if (hasattr(leaf, "ndim") and leaf.ndim >= 1
                and leaf.shape[0] == c_total):
            return P("channel", *([None] * (leaf.ndim - 1)))
        # WFM rails / stacked planes carry 2C or kC leading dims
        if (hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] > 0
                and leaf.shape[0] % c_total == 0
                and leaf.shape[0] // c_total <= 8):
            return P("channel", *([None] * (leaf.ndim - 1)))
        return P(*([None] * getattr(leaf, "ndim", 0)))

    def sharded_tail(state, params, x):
        in_specs = jax.tree.map(_spec_of, (state, params, x))
        out_shape = jax.eval_shape(tail_fn, state, params, x)
        out_specs = jax.tree.map(_spec_of, out_shape)
        return jax.shard_map(tail_fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)(
            state, params, x)

    @jax.jit
    def step(state: ReceiverState, params, iq):
        new_dc, phase2, new_carry, x = front(
            state.dc, state.mixer.phase, state.decim, iq,
            params.tune_hi, params.tune_lo)
        # reshard the (much smaller) decimated stream to channel-only; XLA
        # inserts the gather over the 'time' axis here
        x = lax.with_sharding_constraint(x, csh)
        (audio, demod_state, resamp_state, agc_state, anf_state,
         ff_state, rds_state) = sharded_tail(state, params, x)
        new_state = ReceiverState(
            mixer=MixerState(phase=phase2), decim=new_carry,
            fastfir=ff_state, dc=new_dc, nb=state.nb, anf=anf_state,
            agc=agc_state, demod=demod_state, resamp=resamp_state,
            spec_full=state.spec_full, spec_zoom=state.spec_zoom,
            rds=rds_state, squelch=state.squelch, iqbal=state.iqbal)
        return new_state, audio

    return step


# ------------------------------------------------------------------ front

def _build_front(rx: Receiver, mesh):
    plan = rx.plan
    h = decimator.compose_response(plan)
    n_time = mesh.shape["time"]
    n_local = rx.cfg.frames_per_buffer // n_time
    if n_local % plan.factor:
        raise ValueError(f"per-shard chunk {n_local} not divisible by the "
                         f"decimation factor {plan.factor}")

    return jax.shard_map(
        functools.partial(_front_body, h, plan.factor),
        mesh=mesh,
        in_specs=(P("channel"), P("channel"), P("channel", None),
                  P("channel", "time"), P("channel"), P("channel")),
        out_specs=(P("channel"), P("channel"), P("channel", None),
                   P("channel", "time")),
        check_vma=False,
    )


def _front_body(h_np, factor, dc0, phase0, carry, xl, hi, lo):
    new_dc, z = time_shard.sharded_dc_removal(xl, dc0, front_mod.DC_ALPHA,
                                              "time")
    phase2, new_carry, y = time_shard.sharded_composed_front(
        z, phase0, hi, lo, carry, h_np, factor, "time")
    return new_dc, phase2, new_carry, y
