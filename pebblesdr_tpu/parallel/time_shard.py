"""Time-block (sequence) sharding with ppermute halo exchange.

The SP/CP analog for streaming DSP (SURVEY.md §2.6): one continuous IQ
stream's time axis is split across devices; every FIR/overlap-save stage needs
the last taps-1 input samples of its LEFT neighbor (the in-shard analog of the
carried tail that crosses *block* boundaries in streaming).  This module
provides those halos via jax.lax.ppermute — the direct analog of ring
attention's block rotation — plus time-aware variants of the mixer and the
decimator cascade, all designed to run inside jax.shard_map over a mesh with a
'time' axis.

Streaming semantics: shard 0 consumes the carried tail from the previous
block; shard i>0 consumes its left neighbor's halo; the new carry (the global
block's last taps-1 samples, i.e. the LAST shard's tail) is broadcast to all
shards with an all_gather of the (tiny) per-shard tails.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pebblesdr_tpu.core.precision import DOT_PRECISION
from pebblesdr_tpu.ops import decimator as decim_mod
from pebblesdr_tpu.ops import fir, front


def left_halo(x_local: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """[C, Nl] -> [C, halo]: the last `halo` samples of the LEFT neighbor.
    Shard 0 receives zeros (ppermute semantics)."""
    n = lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return lax.ppermute(x_local[:, -halo:], axis_name, perm)


def _last_shard_tail(x_local: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """[C, halo]: the LAST shard's tail, replicated to every shard — the new
    streaming carry for the next global block."""
    tails = lax.all_gather(x_local[:, -halo:], axis_name, axis=0)  # [T, C, halo]
    return tails[-1]


def sharded_fir_decimate(x_local: jax.Array, taps: jax.Array, carry: jax.Array,
                         decim: int, axis_name: str):
    """Streaming FIR(+decimate) over a time-sharded stream.

    x_local: [C, Nl] this shard's contiguous chunk (Nl % decim == 0);
    taps: [T] real; carry: [C, T-1] the global stream tail from the previous
    block (same value on every shard).

    Returns (y_local [C, Nl//decim], new_carry [C, T-1]).
    Bit-identical to ops.fir.fir_apply on the unsharded stream.
    """
    t = taps.shape[0]
    halo = t - 1
    my_idx = lax.axis_index(axis_name)
    neighbor_tail = left_halo(x_local, halo, axis_name)
    lead = jnp.where(my_idx == 0, carry[:, -halo:] if halo else carry,
                     neighbor_tail)
    ext = jnp.concatenate([lead, x_local], axis=-1)
    c = x_local.shape[0]
    xr = jnp.concatenate([ext.real, ext.imag], axis=0)
    yr = fir._conv_real(xr, taps, decim)
    y = lax.complex(yr[:c], yr[c:]).astype(jnp.complex64)
    new_carry = _last_shard_tail(x_local, halo, axis_name)
    return y, new_carry


def sharded_decimator_apply(plan: decim_mod.DecimatorPlan, carries, x_local,
                            axis_name: str):
    """Time-sharded halfband cascade: each stage exchanges its own halo at its
    own (decimated) rate.  carries: tuple like ops.decimator.state_init."""
    new_carries = []
    y = x_local
    for st, carry in zip(plan.stages, carries):
        taps = jnp.asarray(st.taps, jnp.float32)
        y, nc = sharded_fir_decimate(y, taps, carry, 2, axis_name)
        new_carries.append(nc)
    return tuple(new_carries), y


def sharded_mix(phase0: jax.Array, x_local: jax.Array, f_hi, f_lo,
                axis_name: str):
    """Time-sharded NCO mixer: each shard offsets the phase ramp by its global
    start index (shard_idx * Nl).  phase0: [C] carried fractional phase.

    Returns (new_phase0 [C] — the phase after the FULL global block, identical
    on every shard — and y_local [C, Nl])."""
    nl = x_local.shape[-1]
    n_shards = lax.axis_size(axis_name)
    my_idx = lax.axis_index(axis_name)
    f_hi = jnp.broadcast_to(jnp.asarray(f_hi, jnp.float32), phase0.shape)
    f_lo = jnp.broadcast_to(jnp.asarray(f_lo, jnp.float32), phase0.shape)
    k0 = (my_idx * nl).astype(jnp.float32)
    shard_phase = jnp.mod(phase0 + jnp.mod(k0 * f_hi, 1.0)
                          + jnp.mod(k0 * f_lo, 1.0), 1.0)
    k = jnp.arange(nl, dtype=jnp.float32)[None, :]
    ramp = jnp.mod(k * f_hi[:, None], 1.0) + k * f_lo[:, None]
    ph = jnp.mod(shard_phase[:, None] + ramp, 1.0)
    y = x_local * jnp.exp(-2j * jnp.pi * ph).astype(jnp.complex64)
    ntot = (n_shards * nl).astype(jnp.float32) if hasattr(n_shards, "astype") \
        else jnp.float32(n_shards * nl)
    new_phase = jnp.mod(phase0 + jnp.mod(ntot * f_hi, 1.0)
                        + jnp.mod(ntot * f_lo, 1.0), 1.0)
    return new_phase, y


def sharded_overlap_save(state_local, x_local, mask, axis_name: str):
    """Time-sharded FastFIR overlap-save: the B-sample overlap comes from the
    left neighbor (or the carried state on shard 0).

    state_local: [C, B] previous *global* block's tail (same on all shards);
    x_local: [C, B_local]... for simplicity each shard processes its chunk as
    one overlap-save round with B = Nl (mask must be sized 2*Nl).

    Returns (new_state [C, Nl], y_local [C, Nl]).
    """
    nl = x_local.shape[-1]
    my_idx = lax.axis_index(axis_name)
    neighbor = left_halo(x_local, nl, axis_name)
    prev = jnp.where(my_idx == 0, state_local, neighbor)
    xx = jnp.concatenate([prev, x_local], axis=-1)
    spec = jnp.fft.fft(xx, axis=-1)
    y = jnp.fft.ifft(spec * mask[None, :], axis=-1)[:, nl:].astype(jnp.complex64)
    new_state = _last_shard_tail(x_local, nl, axis_name)
    return new_state, y


def sharded_dc_chunks(x_local: jax.Array, dc0: jax.Array, alpha: float,
                      axis_name: str, chunk: int = 512):
    """Time-sharded chunked-EWMA DC estimate (ops.iir.dc_removal_chunked
    semantics: per-chunk means, EWMA across chunks with coefficient
    alpha^chunk, subtraction uses each chunk's post-update estimate).

    The recurrence crosses shard boundaries; each shard's STARTING estimate
    is seeded closed-form from an all_gather of the per-shard affine maps
    (m_end = A·m_start + b with A = a^K_local and b the locally weighted
    chunk-mean sum), so no shard waits on another's full pass.

    x_local: [C, Nl] complex (Nl % chunk == 0); dc0: [C] complex — the
    carried global estimate entering this block (same on all shards).

    Returns (m_start [C], m_all [C, Kl] per-chunk estimates, new_dc [C] —
    the global end-of-block estimate, identical on every shard).
    """
    c, nl = x_local.shape
    if nl % chunk:
        raise ValueError(f"local chunk {nl} not divisible by dc chunk {chunk}")
    kl = nl // chunk
    a = float(alpha) ** chunk
    means = jnp.mean(x_local.reshape(c, kl, chunk), axis=-1)      # [C, Kl]
    kk = np.arange(kl)
    wv = ((1.0 - a) * a ** (kl - 1 - kk)).astype(np.float32)
    b_loc = jnp.sum(means * jnp.asarray(wv)[None, :], axis=-1)    # [C]
    big_a = np.float32(a ** kl)

    i = lax.axis_index(axis_name)
    tt = lax.axis_size(axis_name)
    bs = lax.all_gather(b_loc, axis_name, axis=0)                 # [T, C]
    j = jnp.arange(tt)
    expnt = jnp.clip(i - 1 - j, 0, None).astype(jnp.float32)
    coef = jnp.where(j < i, jnp.power(big_a, expnt), 0.0)
    m_start = (jnp.power(big_a, i.astype(jnp.float32)) * dc0
               + jnp.sum(coef[:, None] * bs, axis=0))
    # per-chunk closed form: m_k = a^{k+1} m_start + Σ_{j<=k} (1-a) a^{k-j} μ_j
    lm = np.where(kk[:, None] >= kk[None, :],
                  (1.0 - a) * a ** (kk[:, None] - kk[None, :]), 0.0
                  ).astype(np.float32)
    m_all = (jnp.matmul(means, jnp.asarray(lm.T), precision=DOT_PRECISION)
             + jnp.asarray((a ** (kk + 1)).astype(np.float32))[None, :]
             * m_start[:, None])                                  # [C, Kl]
    coef_t = jnp.power(big_a, (tt - 1 - j).astype(jnp.float32))
    new_dc = (jnp.power(big_a, jnp.float32(tt)) * dc0
              + jnp.sum(coef_t[:, None] * bs, axis=0))
    return m_start, m_all, new_dc


def sharded_dc_removal(x_local: jax.Array, dc0: jax.Array, alpha: float,
                       axis_name: str, chunk: int = 512):
    """DC-removed stream + carried estimate: the time-sharded twin of
    ops.iir.dc_removal_chunked.  Returns (new_dc [C], z_local [C, Nl])."""
    c, nl = x_local.shape
    m_start, m_all, new_dc = sharded_dc_chunks(x_local, dc0, alpha,
                                               axis_name, chunk)
    z = (x_local.reshape(c, nl // chunk, chunk)
         - m_all[:, :, None]).reshape(c, nl)
    return new_dc, z


def sharded_composed_front(x_local: jax.Array, phase0: jax.Array, f_hi, f_lo,
                           carry: jax.Array, h_np, factor: int,
                           axis_name: str):
    """Time-sharded NCO mix + WHOLE decimator cascade in one step, using the
    noble-identity composed response (ops.decimator.compose_response) — the
    sharded twin of the Receiver's front end (ops.front).

    Exchanges ONE halo of D = group-delay samples (post-mix) instead of one
    per cascade stage: 1 ppermute + 1 all_gather per block total.  The local
    filtering is ops.front.decimate_composed with the halo as its history.

    x_local: [C, Nl] complex64 (Nl % factor == 0); carry: [C, D] complex64 —
    the previous global block's last D post-mix samples (same on all shards);
    h_np: the composed response (numpy float64/32, len D+1) from
    ops.decimator.compose_response.

    Returns (new_phase [C], new_carry [C, D], y_local [C, Nl//factor]).
    Matches mixer.mix + decimator.apply on the unsharded stream to float32
    rounding.
    """
    d = carry.shape[-1]
    my_idx = lax.axis_index(axis_name)

    new_phase, z_local = sharded_mix(phase0, x_local, f_hi, f_lo, axis_name)

    neighbor = left_halo(z_local, d, axis_name)
    lead = jnp.where(my_idx == 0, carry, neighbor)
    _, y = front.decimate_composed(lead, z_local, np.asarray(h_np), factor)

    new_carry = _last_shard_tail(z_local, d, axis_name)
    return new_phase, new_carry, y
