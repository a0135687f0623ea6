"""comm: the single collective-communication surface of the framework.

SURVEY.md §2.6/§5: the reference's only "communication" is QSemaphore/QMutex
plus TCP sample streaming; this framework instead routes everything through
XLA collectives (NVLink within a host, the network across hosts), wrapped here so the
rest of the code never calls jax.lax primitives directly:

  ring_shift_right / ring_shift_left — ppermute neighbor exchange (halo
      building block used by parallel.time_shard)
  all_sum / all_max / all_mean       — psum/pmax reductions (spectrum
      assembly, metrics aggregation)
  gather_axis                        — all_gather (full-span spectrum from
      time shards)
  broadcast_from                     — one shard's value to all
All functions take the mesh axis name and work inside jax.shard_map.
"""

from __future__ import annotations

import jax
from jax import lax


def ring_shift_right(x: jax.Array, axis_name: str) -> jax.Array:
    """Every shard receives its LEFT neighbor's x (shard 0 receives zeros)."""
    n = lax.axis_size(axis_name)
    return lax.ppermute(x, axis_name, [(i, i + 1) for i in range(n - 1)])


def ring_shift_left(x: jax.Array, axis_name: str) -> jax.Array:
    """Every shard receives its RIGHT neighbor's x (last shard receives zeros)."""
    n = lax.axis_size(axis_name)
    return lax.ppermute(x, axis_name, [(i + 1, i) for i in range(n - 1)])


def ring_rotate(x: jax.Array, axis_name: str, shift: int = 1) -> jax.Array:
    """Cyclic rotation (the ring-attention-style block pass)."""
    n = lax.axis_size(axis_name)
    return lax.ppermute(x, axis_name, [(i, (i + shift) % n) for i in range(n)])


def all_sum(x, axis_name: str):
    return lax.psum(x, axis_name)


def all_max(x, axis_name: str):
    return lax.pmax(x, axis_name)


def all_mean(x, axis_name: str):
    return lax.pmean(x, axis_name)


def gather_axis(x: jax.Array, axis_name: str, axis: int = 0) -> jax.Array:
    """Concatenate every shard's x along `axis` (tiled all-gather)."""
    return lax.all_gather(x, axis_name, axis=axis, tiled=True)


def broadcast_from(x: jax.Array, axis_name: str, src: int = 0) -> jax.Array:
    """Every shard gets shard `src`'s value."""
    g = lax.all_gather(x, axis_name, axis=0)
    return g[src]


def axis_index(axis_name: str):
    return lax.axis_index(axis_name)


def reduce_scatter_sum(x: jax.Array, axis_name: str, axis: int = 0) -> jax.Array:
    """Sum across shards, scatter chunks back (psum_scatter)."""
    return lax.psum_scatter(x, axis_name, scatter_dimension=axis, tiled=True)
