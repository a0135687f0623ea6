"""Mode-expert parallelism (EP analog, SURVEY §2.6): route channels to
per-demod-mode expert kernels.

The reference runs ONE demod mode at a time, chosen from the static
``demodInfo[]`` table (application/demod.cpp:25-40, dispatch :100-141).  This
framework generalizes that table into *static routing*: every channel of
a wideband capture carries a demod-mode assignment made at build time, the
channels are grouped by mode, and each group runs its own expert chain — its
own decimation plan (AM protects 30 kHz, WFM ≥400 kHz — receiver.cpp:192-218),
bandpass, AGC profile, and demod kernel graph.  Because routing is static
(modes don't change sample-to-sample), no device ever spends FLOPs on an
inactive expert branch — the "expert" is a separately jitted, separately
placed program, not a masked branch inside one program.

With a device mesh, each expert gets a disjoint slice of the channel-axis
devices (proportional to its channel count) and shards its channels over that
sub-mesh.  The per-expert steps are independent async dispatches, so all
experts run concurrently — the EP twin of the channel-parallel (DP) map in
``parallel.channelizer``.

No counterpart file in the reference (it is single-mode); the routing-table
concept is the ``demodInfo[]`` analog per SURVEY §2.6.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode


@dataclasses.dataclass(frozen=True)
class ChannelAssignment:
    """One channel of the routing table: demod mode + tune offset (Hz from
    the capture center)."""
    mode: DemodMode
    tune_hz: float


@dataclasses.dataclass(frozen=True)
class ExpertGroup:
    """One expert: a demod mode plus the (original) channel indices routed
    to it, in routing-table order."""
    mode: DemodMode
    channel_ids: tuple  # original channel indices
    tunes: np.ndarray   # [c_e] Hz


def route_channels(assignments) -> list[ExpertGroup]:
    """Static routing table: group channels by mode, preserving first-seen
    mode order and per-mode channel order (the demodInfo[] analog)."""
    order: list[DemodMode] = []
    by_mode: dict[DemodMode, list[int]] = {}
    for i, a in enumerate(assignments):
        if a.mode not in by_mode:
            by_mode[a.mode] = []
            order.append(a.mode)
        by_mode[a.mode].append(i)
    return [
        ExpertGroup(mode=m, channel_ids=tuple(by_mode[m]),
                    tunes=np.asarray(
                        [assignments[i].tune_hz for i in by_mode[m]],
                        np.float64))
        for m in order
    ]


def partition_devices(devices, groups) -> list[list]:
    """Split a flat device list into per-expert groups, proportional to
    channel count (largest-remainder; every expert gets >= 1 device and at
    most its channel count)."""
    n_dev = len(devices)
    total = sum(len(g.channel_ids) for g in groups)
    if n_dev < len(groups):
        raise ValueError(f"{len(groups)} experts need >= {len(groups)} "
                         f"devices, have {n_dev}")
    quota = [len(g.channel_ids) * n_dev / total for g in groups]
    counts = [max(1, min(len(g.channel_ids), int(q)))
              for q, g in zip(quota, groups)]
    # the max(1, ...) lift can overshoot the device count (e.g. channels
    # [10, 1, 1] on 4 devices -> [2, 1, 1] + remainder logic): reconcile by
    # shrinking the largest groups first, never below 1 device
    while sum(counts) > n_dev:
        i = max(range(len(counts)), key=lambda j: (counts[j], quota[j]))
        if counts[i] <= 1:  # unreachable given n_dev >= len(groups)
            raise ValueError("cannot give every expert a device")
        counts[i] -= 1
    # distribute any remainder by largest fractional part
    rem = n_dev - sum(counts)
    frac = sorted(range(len(groups)), key=lambda i: quota[i] - int(quota[i]),
                  reverse=True)
    k = 0
    while rem > 0 and k < len(frac):
        i = frac[k % len(frac)]
        if counts[i] < len(groups[i].channel_ids):
            counts[i] += 1
            rem -= 1
        k += 1
    out, pos = [], 0
    for c in counts:
        out.append(list(devices[pos:pos + c]))
        pos += c
    return out


class ModeExpertChannelizer:
    """One wideband capture -> N channels routed to per-mode expert chains.

    assignments: sequence of ChannelAssignment, one per channel of the
    capture (original channel order).  Each distinct mode becomes an expert
    ``Receiver`` built for that mode's decimation plan / bandpass / AGC.

    devices: optional flat device list; partitioned into per-expert groups
    (proportional to channel count) and each expert's channels shard over
    its group via a one-axis ('channel',) sub-mesh.  Without devices, all
    experts run on the default device (still separately compiled programs).

    step(states, iq) -> (states', outs): iq is the capture replicated per
    channel, [C_total, N] complex64 (each expert mixes its own tunes — the
    same contract as Receiver.step).  outs is a list, one dict per expert,
    in routing order; ``groups[e].channel_ids`` maps rows back to the
    original channel numbering.
    """

    def __init__(self, sample_rate: int, frames_per_buffer: int,
                 assignments, devices=None, spectra: bool = False,
                 **rx_kwargs):
        self.groups = route_channels(assignments)
        self._tunes = [np.array(g.tunes, np.float64) for g in self.groups]
        self.spectra = spectra
        self.receivers: list[Receiver] = []
        self.params = []
        self.shardings = []
        dev_groups = (partition_devices(devices, self.groups)
                      if devices is not None else [None] * len(self.groups))
        self.device_groups = dev_groups
        for g, devs in zip(self.groups, dev_groups):
            c = len(g.channel_ids)
            kw = dict(rx_kwargs)
            if devs is not None and len(devs) > 1:
                while c % len(devs):  # even channel shards only
                    devs = devs[:-1]
            rx = Receiver(ReceiverConfig(
                sample_rate=sample_rate, frames_per_buffer=frames_per_buffer,
                channels=c, mode=g.mode, **kw))
            self.receivers.append(rx)
            self.params.append(rx.default_params(g.tunes))
            if devs is not None and len(devs) > 1:
                from jax.sharding import Mesh, NamedSharding, PartitionSpec
                mesh = Mesh(np.asarray(devs), ("channel",))
                self.shardings.append(
                    NamedSharding(mesh, PartitionSpec("channel", None)))
            elif devs is not None:
                self.shardings.append(
                    jax.sharding.SingleDeviceSharding(devs[0]))
            else:
                self.shardings.append(None)

    @property
    def n_experts(self) -> int:
        return len(self.groups)

    def init_states(self):
        states = []
        for rx, sh in zip(self.receivers, self.shardings):
            st = rx.init_state()
            if sh is not None:
                st = jax.tree.map(lambda a: jax.device_put(a, _leaf_sh(sh, a)),
                                  st)
            states.append(st)
        return states

    def retune(self, channel_id: int, tune_hz: float):
        """Retune one original channel (runtime param change, no recompile)."""
        for e, g in enumerate(self.groups):
            if channel_id in g.channel_ids:
                slot = g.channel_ids.index(channel_id)
                self._tunes[e][slot] = tune_hz
                self.params[e] = self.receivers[e].retune(
                    self.params[e], self._tunes[e])
                return
        raise KeyError(channel_id)

    def step(self, states, iq):
        """iq: [C_total, N] complex64 (rows in ORIGINAL channel order), a
        single wideband row [1, N] shared by all channels, or the packed
        [N, 2*C_total] float32 plane (re columns then im columns; [N, 2] =
        one shared capture).  Experts are dispatched
        back-to-back (async), so device groups overlap."""
        outs = []
        new_states = []
        packed = jnp.issubdtype(iq.dtype, jnp.floating)
        ctot = iq.shape[1] // 2 if packed else iq.shape[0]
        shared = ctot == 1
        for e, (rx, g, sh) in enumerate(zip(self.receivers, self.groups,
                                            self.shardings)):
            ce = len(g.channel_ids)
            ids = (np.zeros(ce, np.int64) if shared
                   else np.asarray(g.channel_ids))
            if packed:
                x = iq[:, np.concatenate([ids, ctot + ids])]
            elif shared:
                x = jnp.broadcast_to(iq, (ce, iq.shape[1]))
            else:
                x = iq[ids]
            if sh is not None:
                x = jax.device_put(x, sh)
            st, out = rx.step(states[e], self.params[e], x,
                              spectra=self.spectra)
            new_states.append(st)
            outs.append(out)
        return new_states, outs

    def audio_by_channel(self, outs) -> dict[int, np.ndarray]:
        """Reassemble per-expert audio into {original channel id: audio}."""
        result = {}
        for g, out in zip(self.groups, outs):
            a = np.asarray(out["audio"])
            for slot, cid in enumerate(g.channel_ids):
                result[cid] = a[slot]
        return result


def _leaf_sh(sh, a):
    """State leaves with a leading channel axis shard over it; scalars and
    shared leaves replicate."""
    from jax.sharding import NamedSharding, PartitionSpec
    if isinstance(sh, NamedSharding) and getattr(a, "ndim", 0) >= 1:
        n = sh.mesh.shape["channel"]
        if a.shape[0] % n == 0 and a.shape[0] >= n:
            spec = PartitionSpec("channel", *([None] * (a.ndim - 1)))
            return NamedSharding(sh.mesh, spec)
        return NamedSharding(sh.mesh, PartitionSpec(*([None] * a.ndim)))
    return sh
