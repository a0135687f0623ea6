"""Intra-kernel (TP analog, SURVEY §2.6) sharded wideband FFT.

The reference's spectrum path FFTs at most 65535 bins on one core
(pebblelib/fft.h:21-22).  For a multi-card wideband capture (one contiguous
time block too large or too slow for a single chip), this module splits ONE
FFT across the mesh with the classic four-step (Cooley-Tukey N = N1*N2)
factorization — the SDR twin of tensor-parallel matmul sharding:

factorization (Bailey's algorithm — X[k2*N1+k1] = FFT_n2(W_N^{k1*n2} *
FFT_n1(x[n1, n2]))):

  1. view the time block as a row-major [N1, N2] matrix, time-sharded along
     N1 (contiguous time shards, the natural capture layout);
  2. global transpose (ONE ``lax.all_to_all``) so the n1 axis is local;
  3. local length-N1 FFTs + local twiddle multiply W_N^{k1*n2};
  4. global transpose back (second all_to_all) so the n2 axis is local;
  5. local length-N2 FFTs;
  6. final global transpose (third all_to_all) into natural bin order.

All communication is 3 all_to_all transposes of N complex samples — the
textbook distributed-FFT cost, riding NVLink between the cards of a host.  The result is
the full-length DFT in natural order, sharded contiguously along the
frequency axis — exactly what a sharded waterfall/spectrum wants (each
device renders its own frequency span; no gather needed).

Validated against jnp.fft.fft on the forced 8-device CPU mesh
(tests/test_dist_fft.py).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


def _a2a_transpose(a: jax.Array, axis_name: str, s: int) -> jax.Array:
    """Global transpose of a row-sharded matrix: local [R/S, C] rows of the
    global [R, C] -> local [C/S, R] rows of the global [C, R], via one
    all_to_all (device d keeps column group d of every row)."""
    r_loc, c = a.shape
    a = a.reshape(r_loc, s, c // s)
    b = lax.all_to_all(a, axis_name, split_axis=1, concat_axis=0)
    return b.reshape(s * r_loc, c // s).T


def _local_four_step(axis_name: str, n_shards: int, x_loc: jax.Array):
    """x_loc: [N1/S, N2] complex — this device's contiguous time rows.
    Returns [N2/S, N1] complex: this device's contiguous frequency rows of
    the [N2, N1] natural-order result matrix (X[k2*N1 + k1] at [k2, k1])."""
    n1_loc, n2 = x_loc.shape
    s = n_shards
    n1 = n1_loc * s
    n = n1 * n2
    d = lax.axis_index(axis_name)

    # transpose so the n1 axis is local -> rows n2, cols n1
    t1 = _a2a_transpose(x_loc, axis_name, s)            # [N2/S, N1]

    # local length-N1 FFTs over n1 -> B[n2, k1], then twiddle W_N^{k1*n2}
    b = jnp.fft.fft(t1, axis=1)
    rows_n2 = (d * (n2 // s) + jnp.arange(n2 // s)).astype(jnp.float32)
    k1 = jnp.arange(n1, dtype=jnp.float32)
    ang = (-2.0 * math.pi / n) * rows_n2[:, None] * k1[None, :]
    b = b * lax.complex(jnp.cos(ang), jnp.sin(ang))

    # transpose back -> rows k1, cols n2; local length-N2 FFTs over n2
    t2 = _a2a_transpose(b, axis_name, s)                # [N1/S, N2]
    c = jnp.fft.fft(t2, axis=1)                         # C[k1, k2]

    # final transpose into natural order: rows k2, cols k1
    return _a2a_transpose(c, axis_name, s)              # [N2/S, N1]


def fft_sharded(x2d: jax.Array, mesh: Mesh, axis: str = "time") -> jax.Array:
    """Distributed DFT of one long block.

    x2d: [N1, N2] complex64 — the length N1*N2 time block in row-major order
    (so sharding axis 0 over ``axis`` = contiguous time shards).  N1 and N2
    must both be divisible by the axis size.

    Returns [N2, N1] complex64, sharded along axis 0: flattening row-major
    gives the natural-order DFT X[k] (k = k2*N1 + k1), and each device holds
    the contiguous frequency span k2 ∈ [d*N2/S, (d+1)*N2/S).
    """
    s = mesh.shape[axis]
    n1, n2 = x2d.shape
    if n1 % s or n2 % s:
        raise ValueError(f"[N1={n1}, N2={n2}] not divisible by the "
                         f"'{axis}' axis size {s}")
    fn = jax.shard_map(
        functools.partial(_local_four_step, axis, s), mesh=mesh,
        in_specs=P(axis, None), out_specs=P(axis, None), check_vma=False)
    return fn(x2d)


def power_spectrum_sharded(x2d: jax.Array, mesh: Mesh, axis: str = "time",
                           window: np.ndarray | None = None) -> jax.Array:
    """Sharded windowed power spectrum of one wideband time block: |X|^2 / N^2
    in natural bin order [N], sharded contiguously along frequency.

    window: optional length-N real window (applied locally — elementwise over
    the time sharding, no communication); coherent-gain normalization is the
    caller's convention (ops.spectrum.calc handles display dB).
    """
    n1, n2 = x2d.shape
    n = n1 * n2
    if window is not None:
        x2d = x2d * jnp.asarray(window, x2d.dtype).reshape(n1, n2)
    xk = fft_sharded(x2d, mesh, axis)
    p = (jnp.real(xk) ** 2 + jnp.imag(xk) ** 2) / float(n) ** 2
    return p.reshape(n)
