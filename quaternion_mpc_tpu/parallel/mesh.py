"""Scenario-fleet parallelism: mesh construction, sharding, fleet collectives.

The reference's "distribution" is ROS pub/sub + one mutex (SURVEY.md §2.3);
here it is a scenario-sharded device mesh: thousands of randomized Go1
scenarios per device, sharded over the flat ('scenario',) mesh axis with
`shard_map`, metrics reduced on-device with `psum` across devices before any
host transfer. Multi-host: same code — `jax.distributed` + every device of
every host flattened into the scenario axis.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SCENARIO_AXIS = "scenario"


def scenario_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (SCENARIO_AXIS,))


def shard_batch(tree, mesh: Mesh):
    """Place a scenario-batched pytree with the batch axis over the mesh."""
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))

    def put(x):
        return jax.device_put(x, sharding) if hasattr(x, "ndim") and x.ndim > 0 else x

    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def fleet_map(step_fn: Callable, mesh: Mesh, *, has_metrics: bool = True):
    """Lift a per-scenario step into a sharded fleet step.

    step_fn: (carry, inputs) -> (carry, metrics) for ONE scenario.
    Returns fleet_fn operating on batch-leading pytrees sharded over the
    scenario axis. Per-shard work is vmapped; scalar metrics are psum-reduced
    across devices inside the shard_map (no host round trip), so the returned
    metrics are fleet totals replicated on every device.
    """
    vstep = jax.vmap(step_fn)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS)),
        out_specs=(P(SCENARIO_AXIS), P()),
        check_vma=False,
    )
    def fleet_fn(carry, inputs):
        carry, metrics = vstep(carry, inputs)
        if has_metrics:
            metrics = jax.tree.map(
                lambda m: jax.lax.psum(jnp.sum(m, axis=0), SCENARIO_AXIS), metrics
            )
        return carry, metrics

    return fleet_fn


def fleet_shard(fleet_step: Callable, mesh: Mesh, *, reduce_metrics: bool = True):
    """Shard a FLEET-native (batch-leading) step over the scenario mesh axis.

    This is the multi-device fleet path: `fleet_step` is one of
    ``runtime.step.make_fleet_*`` — batch-leading (carry, sp, joy) pytrees
    with the batch-LAST fleet solver underneath (solver/fleet.py). Each
    device runs the whole fleet step on its local scenario shard
    (transposing to batch-last inside the shard); per-scenario metrics are
    psum-reduced to fleet totals across devices (replicated on every device)
    unless ``reduce_metrics=False`` (then metrics stay per-scenario,
    sharded).

    Contrast `fleet_map`, which lifts a PER-SCENARIO step via vmap — correct
    but keeps the batch-leading layout the fleet solver avoids.
    """
    metrics_spec = P() if reduce_metrics else P(SCENARIO_AXIS)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS), P(SCENARIO_AXIS)),
        out_specs=(P(SCENARIO_AXIS), metrics_spec),
        check_vma=False,
    )
    def sharded(carry, sp, joy):
        carry, metrics = fleet_step(carry, sp, joy)
        if reduce_metrics:
            metrics = jax.tree.map(
                lambda m: jax.lax.psum(jnp.sum(m, axis=0), SCENARIO_AXIS), metrics
            )
        return carry, metrics

    return sharded


def fleet_mean(values, axis_name: str = SCENARIO_AXIS):
    """On-device fleet mean (use inside shard_map)."""
    total = jax.lax.psum(jnp.sum(values, axis=0), axis_name)
    count = jax.lax.psum(values.shape[0], axis_name)
    return total / count
