"""Device mesh construction and sharding helpers.

The reference has no distributed layer (SURVEY.md §2.6: single Qt process,
QSemaphore/QMutex); this module *introduces* it: one mesh with
named axes

  channel — DP analog: independent demod chains sharded as a pure map
  time    — SP/CP analog: one continuous IQ stream's time axis sharded with
            ppermute halo exchange (see parallel.time_shard)

plus helpers to place [channels, block] arrays and chain state pytrees.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(channel: int = 1, time: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = channel * time
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = np.asarray(devices[:n]).reshape(channel, time)
    return Mesh(devs, ("channel", "time"))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """[C, N] arrays: channels split over the 'channel' axis, time replicated."""
    return NamedSharding(mesh, P("channel", None))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """[C, N] arrays: channels over 'channel', time over 'time'."""
    return NamedSharding(mesh, P("channel", "time"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state, mesh: Mesh):
    """Place a chain-state pytree: leaves with a leading channel axis are
    sharded over 'channel', scalars replicated."""
    csh = channel_sharding(mesh)
    rep = replicated(mesh)

    def place(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] % mesh.shape["channel"] == 0:
            spec = P("channel", *([None] * (leaf.ndim - 1)))
            return jax.device_put(leaf, NamedSharding(mesh, spec))
        return jax.device_put(leaf, rep)

    return jax.tree.map(place, state)
