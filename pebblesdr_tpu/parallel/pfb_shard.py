"""Sharded PFB dense-bank step: one wideband capture -> many stations across
a (channel x time) device mesh.

The polyphase filterbank front (ops.pfb) is a strided FIR + transform over
ONE full-rate stream, so it shards over TIME with a single ppermute halo of
state_len = T·M − hop input samples (the filterbank's carry tail — the same
left-neighbor protocol as every other time-sharded conv here,
parallel/time_shard.py).  Each shard then holds all M channels for ITS time
span; the per-station tail Receiver (fine-tune mix -> FastFIR -> AGC ->
demod -> resample at the LOW channel rate) wants whole time streams per
channel, so one sharding constraint re-lays the (much smaller) channel-rate
streams channel-sharded and XLA inserts the all-to-all over NVLink.

Streaming-exact vs the single-chip chain.pfb_bank.PfbBankReceiver
(tests/test_pfb_bank.py validates on an 8-device CPU mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from pebblesdr_tpu.chain.pfb_bank import PfbBankReceiver
from pebblesdr_tpu.ops import pfb
from pebblesdr_tpu.parallel import time_shard


def build_sharded_bank_step(bank: PfbBankReceiver, mesh):
    """Returns a jitted step(state, params, iq) with iq [N] (or [1, N])
    complex64 time-sharded over the mesh; state from bank.init_state().

    The tail Receiver's whole per-channel graph (mixer residual tune,
    FastFIR, AGC, demod, resampler, spectra, S-meter) runs channel-sharded
    via GSPMD — the same constraint pattern as parallel.channelizer."""
    plan = bank.pfb_plan
    n_time = mesh.shape["time"]
    n_local = bank.frames_per_buffer // n_time
    if n_local % (plan.hop * plan.os):
        # os=2: whole frame PAIRS per shard keep the per-frame twiddle's
        # parity globally consistent (see ops.pfb.apply)
        raise ValueError(f"per-shard chunk {n_local} not divisible by "
                         f"hop*os = {plan.hop * plan.os}")
    state_len = plan.state_len

    def front_body(carry, xl):
        # carry: [1, state_len] (the global stream tail, same on every
        # shard); xl: [1, N_l] this shard's contiguous span
        i = lax.axis_index("time")
        neighbor = time_shard.left_halo(xl, state_len, "time")
        lead = jnp.where(i == 0, carry, neighbor)
        _, y = pfb.apply(plan, lead, xl)               # [1, M, N_l/hop]
        new_carry = time_shard._last_shard_tail(xl, state_len, "time")
        return new_carry, y[0]

    front = jax.shard_map(
        front_body, mesh=mesh,
        in_specs=(P(None, None), P(None, "time")),
        out_specs=(P(None, None), P(None, "time")),
        check_vma=False,
    )
    csh = NamedSharding(mesh, P("channel", None))
    chan_idx = jnp.asarray(np.asarray(bank.chan_idx))

    @jax.jit
    def step(state, params, iq, spectra: bool = True):
        pfb_state, rx_state = state
        x = iq[None, :] if iq.ndim == 1 else iq
        pfb_state, y = front(pfb_state, x)             # [M, K] time-sharded
        ch = y[chan_idx]                               # station channels
        # reshard channel-rate streams to channel-sharded; XLA inserts the
        # all-to-all over the time axis here (the streams are factor-hop
        # smaller than the capture)
        ch = lax.with_sharding_constraint(ch, csh)
        rx_state, out = bank.rx._step_impl(rx_state, params, ch,
                                           spectra=spectra)
        return (pfb_state, rx_state), out

    return step
