"""Multi-host fleet: `jax.distributed` bring-up + scaling-efficiency harness.

The reference's "multi-node" story is ROS topics over TCP between processes
on one host (SURVEY.md §2.3); here it is one controller program per host,
all hosts joined into a single JAX runtime, the scenario axis sharded across
every device of every host, metrics psum'd across devices.

Usage on a cluster (one process per host):

    from quaternion_mpc_tpu.parallel import distributed
    distributed.init("host0:1234", num_processes=2, process_id=rank)
    mesh = distributed.global_scenario_mesh()
    ... parallel.mesh.fleet_map(step, mesh) ...

`scaling_report` measures weak-scaling efficiency and runs identically on a
virtual CPU mesh in CI.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import jax
import numpy as np

from quaternion_mpc_tpu.parallel import mesh as mesh_mod


def init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Join this host into the distributed runtime. Pass the coordinator
    address, process count and this process's id explicitly. No-op
    (single-process) when nothing to join."""
    if coordinator_address is None and jax.process_count() == 1 and num_processes in (None, 1):
        return {
            "process_id": 0,
            "process_count": 1,
            "local_devices": len(jax.local_devices()),
            "global_devices": len(jax.devices()),
        }
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def global_scenario_mesh() -> "jax.sharding.Mesh":
    """('scenario',) mesh over every device in the slice (all hosts)."""
    return mesh_mod.scenario_mesh(jax.devices())


def _time_fleet(step_jit, carry, inputs, iters: int) -> float:
    out = step_jit(carry, inputs)
    jax.block_until_ready(out[0])
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = step_jit(carry, inputs)
        jax.block_until_ready(out[0])
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def scaling_report(
    make_step: Callable[[], Callable],
    make_batch: Callable[[int], tuple],
    device_counts: Sequence[int],
    per_device_batch: int,
    iters: int = 5,
) -> dict:
    """Weak-scaling sweep: per-device batch held constant while the mesh
    grows. Returns throughput per count and efficiency vs the 1-device run.

    make_step() -> per-scenario step(carry, inputs); make_batch(B) ->
    (carry, inputs) batch-leading pytrees.
    """
    devices = jax.devices()
    results = {}
    for n in device_counts:
        if n > len(devices):
            continue
        m = mesh_mod.scenario_mesh(devices[:n])
        fleet = mesh_mod.fleet_map(make_step(), m)
        B = per_device_batch * n
        carry, inputs = make_batch(B)
        carry = mesh_mod.shard_batch(carry, m)
        inputs = mesh_mod.shard_batch(inputs, m)
        step_jit = jax.jit(fleet)
        t = _time_fleet(step_jit, carry, inputs, iters)
        results[n] = {"batch": B, "step_s": t, "steps_per_sec": B / t}
    base = None
    for n in sorted(results):
        per_dev = results[n]["steps_per_sec"] / n
        if base is None:
            base = per_dev
        results[n]["efficiency"] = per_dev / base
    return results


def scaling_report_fleet(
    fleet_step: Callable,
    make_batch: Callable[[int], tuple],
    device_counts: Sequence[int],
    per_device_batch: int,
    iters: int = 5,
) -> dict:
    """Weak-scaling sweep for a FLEET-NATIVE step (batch-leading pytrees,
    batch-last solver inside — runtime.step.make_fleet_*): the step is
    sharded over the ('scenario',) mesh with `fleet_shard`, per-device batch
    held constant while the mesh grows. Multi-device throughput is measured
    on this path, not on a toy step.

    make_batch(B) -> (carry, sp, joy) batch-leading pytrees.
    """
    devices = jax.devices()
    results = {}
    for n in device_counts:
        if n > len(devices):
            continue
        m = mesh_mod.scenario_mesh(devices[:n])
        sharded = mesh_mod.fleet_shard(fleet_step, m)
        B = per_device_batch * n
        carry, sp, joy = make_batch(B)
        carry = mesh_mod.shard_batch(carry, m)
        sp = mesh_mod.shard_batch(sp, m)
        joy = mesh_mod.shard_batch(joy, m)
        step_jit = jax.jit(sharded)
        out = step_jit(carry, sp, joy)
        jax.block_until_ready(out[0])
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = step_jit(carry, sp, joy)
            jax.block_until_ready(out[0])
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        results[n] = {"batch": B, "step_s": t, "steps_per_sec": B / t}
    base = None
    for n in sorted(results):
        per_dev = results[n]["steps_per_sec"] / n
        if base is None:
            base = per_dev
        results[n]["efficiency"] = per_dev / base
    return results
