"""The full-rate front end: DC blocker -> static IQ balance -> noise blanker
-> NCO mix -> composed-FIR decimation, as plain XLA ops.

This is the whole full-rate half of the chain (receiver.cpp:814-911; the
reference's per-sample CDownConvert loop, downconvert.cpp:257-325).  Each
stage is one of the streaming ops below it — ops.iir.dc_removal_chunked,
ops.scanops.iq_balance / noise_blanker_chunked, ops.mixer — and the
decimator cascade is collapsed by the noble identity into ONE composed FIR
(ops.decimator.compose_response), applied as fir.fir_apply_real_signal's
segmented banded matmul on the stacked [re; im] rows: each segment of the
history-extended stream is one row of a batched matmul against the
[seg + D, seg/F] banded operator (D is the composed group delay).  On an
H100 this form ran 6.5x faster than a polyphase convolution (cuDNN, F input
features, one output feature) and 10x faster than the strided D+1-tap
convolution, and ahead of the per-stage cascade (PERF.md, PR 1).

The same code serves one block (Receiver.step) and K concatenated blocks
(Receiver.step_many's batched graph): every stage is streaming-exact, and
the NCO seeds each block's phase exactly as K sequential calls would.

State: dc [C] complex64 (the chunked DC estimate) and hist [C, D] complex64
(the last D post-mix samples, the composed FIR's history).  The sharded
channelizer (parallel.channelizer) carries the same layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.ops import decimator, fir, mixer

DC_ALPHA = 0.9999  # demod_am.cpp:44 (the reference's DC blocker alpha)


def hist_init(plan: decimator.DecimatorPlan, channels: int) -> jax.Array:
    """Zero composed-FIR history [C, D] complex64."""
    d = len(decimator.compose_response(plan)) - 1
    return jnp.zeros((channels, d), jnp.complex64)


def decimate_composed(hist: jax.Array, x: jax.Array, h: np.ndarray,
                      factor: int):
    """Streaming composed-FIR decimation.

    y[m] = sum_j h[j] * xx[m*F - j] over the history-extended stream
    xx = [hist | x] — the same alignment as decimator.apply's stage
    cascade.  hist: [C, D] complex64; x: [C, N] complex64, N % F == 0;
    h: the composed taps (numpy, len D+1).
    Returns (hist' [C, D], y [C, N/F])."""
    c = x.shape[0]
    if len(h) == 1:  # a plan with no stages: H = [1]
        return hist, x * np.float32(h[0])
    rows = jnp.concatenate([x.real, x.imag], axis=0)           # [2C, N]
    tail = jnp.concatenate([hist.real, hist.imag], axis=0)     # [2C, D]
    y, tail = fir.fir_apply_real_signal(rows, None, tail, decim=factor,
                                        taps_np=np.asarray(h, np.float32))
    return (jax.lax.complex(tail[:c], tail[c:]),
            jax.lax.complex(y[:c], y[c:]))


def mix_blocks(phase: jax.Array, x: jax.Array, f_hi, f_lo, n_block: int):
    """NCO mix of K = N/n_block concatenated blocks: block k starts at the
    phase K sequential mixer.mix calls would have reached, so the batched
    and per-block paths agree exactly, and no phase product spans more
    than one block.  phase/f_hi/f_lo: [C].  Returns (phase', y [C, N])."""
    c, n = x.shape
    k = n // n_block
    f_hi = jnp.broadcast_to(jnp.asarray(f_hi, jnp.float32), phase.shape)
    f_lo = jnp.broadcast_to(jnp.asarray(f_lo, jnp.float32), phase.shape)
    starts = []
    ph = phase
    for _ in range(k):
        starts.append(ph)
        ph = jnp.mod(ph + jnp.mod(n_block * f_hi, 1.0) + n_block * f_lo, 1.0)
    seeds = jnp.stack(starts, axis=1).reshape(c * k)
    osc = mixer.oscillator(seeds, n_block, jnp.repeat(f_hi, k),
                           jnp.repeat(f_lo, k))                 # [C*K, n]
    return ph, x * osc.reshape(c, n)
