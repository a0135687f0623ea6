"""Multi-host execution: jax.distributed bring-up + DCN input distribution.

BASELINE.json config #5: a wideband capture split across N hosts, each host
feeding its local devices, time-block sharded with NVLink halo exchange inside a
slice and DCN carrying the host-boundary halos.  This module provides the
host-side plumbing; the device-side sharding lives in parallel.time_shard /
parallel.channelizer and is host-count agnostic (shard_map over the global
mesh — XLA routes the ppermute hop that crosses hosts over DCN
automatically).

Without multi-host hardware this code path is exercised on forced-host CPU meshes
(tests) and via __graft_entry__.dryrun_multichip; on real hosts only
`initialize()` differs (coordinator address from the launcher).
"""

from __future__ import annotations

import jax
import numpy as np

from pebblesdr_tpu.parallel import mesh as mesh_mod


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed bring-up (no-op when single-process / already up)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(channel: int | None = None, time: int | None = None):
    """Mesh over ALL devices (across hosts).  Defaults: time = devices per
    host (so time halos ride NVLink), channel = number of hosts (channel
    parallelism crosses DCN only at input distribution, never per-block)."""
    n = len(jax.devices())
    per_host = len(jax.local_devices())
    if time is None:
        time = per_host
    if channel is None:
        channel = n // time
    return mesh_mod.make_mesh(channel=channel, time=time)


def distribute_host_blocks(mesh, local_iq_ri: np.ndarray):
    """Assemble the global [C, 2, N] float32 input from per-host local blocks.

    Each host holds the channels assigned to its mesh rows (host h feeds
    channels [h*C/nh : (h+1)*C/nh]); jax.make_array_from_process_local_data
    builds the sharded global array without any host gathering — the DCN
    input-distribution path (ProducerConsumer across hosts).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("channel", None, "time"))
    c_local = local_iq_ri.shape[0]
    n_hosts = jax.process_count()
    global_shape = (c_local * n_hosts, local_iq_ri.shape[1], local_iq_ri.shape[2])
    return jax.make_array_from_process_local_data(sharding, local_iq_ri,
                                                  global_shape)


def scaling_report(step_fn, state, params, iq, steps: int = 10) -> dict:
    """Measure aggregate samples/s on the current (possibly multi-host) mesh;
    every host returns the same dict (psum'd sample count / max wall time)."""
    import time

    state, out = step_fn(state, params, iq)  # compile
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, out = step_fn(state, params, iq)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    c, _, n = iq.shape
    samples = c * n * steps
    return {
        "devices": len(jax.devices()),
        "hosts": jax.process_count(),
        "samples_per_s": samples / dt,
        "msps_per_device": samples / dt / 1e6 / len(jax.devices()),
        "wall_s": dt,
    }
