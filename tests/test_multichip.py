"""Sharded-fleet tests on the virtual 8-device CPU mesh (SURVEY.md §4d)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quaternion_mpc_tpu.control import quat_mpc
from quaternion_mpc_tpu.models import srb
from quaternion_mpc_tpu.parallel import mesh as mesh_mod
from quaternion_mpc_tpu.runtime import step as rt
from quaternion_mpc_tpu.solver import SolverOptions
from quaternion_mpc_tpu.utils import config as cfg_mod


@pytest.fixture(scope="module")
def fleet_setup():
    n_dev = len(jax.devices())
    assert n_dev == 8, f"conftest should provide 8 virtual cpu devices, got {n_dev}"
    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    carry1, sp1 = rt.init_scenario(wts, srb.go1_params().foot_pos, dtype=dtype)
    joy1 = rt.neutral_joy(dtype)
    B = 16
    tile = lambda t: jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), t)
    return tile(carry1), tile(sp1), tile(joy1), B


def test_fleet_step_sharded(fleet_setup):
    carry, sp, joy, B = fleet_setup
    m = mesh_mod.scenario_mesh()
    step = rt.make_standing_step(
        horizon=4, opts=SolverOptions(al_iterations=1, ilqr_iterations=2)
    )
    fleet = mesh_mod.fleet_map(lambda c, inp: step(c, inp[0], inp[1]), m)
    carry_s = mesh_mod.shard_batch(carry, m)
    inputs_s = mesh_mod.shard_batch((sp, joy), m)
    new_carry, metrics = jax.jit(fleet)(carry_s, inputs_s)
    jax.block_until_ready(new_carry)
    # psum'd metrics are fleet totals
    assert float(metrics.alive) == B
    # sharded result equals the unsharded vmap result
    vstep = jax.jit(jax.vmap(step))
    ref_carry, ref_metrics = vstep(carry, (lambda t: t)(sp), joy)
    np.testing.assert_allclose(
        np.array(new_carry.plant.pos), np.array(ref_carry.plant.pos), atol=1e-5
    )
    np.testing.assert_allclose(
        float(metrics.mpc_cost), float(jnp.sum(ref_metrics.mpc_cost)), rtol=1e-4
    )


def test_fleet_shard_matches_single_device(fleet_setup):
    """The batch-LAST fleet solver sharded over the mesh == the same fleet
    step on one device (VERDICT r1 #1: the fast path must be the sharded
    path). Metrics psum to fleet totals across devices."""
    carry, sp, joy, B = fleet_setup
    # perturb per-scenario so shards aren't trivially identical
    vel = jnp.asarray(
        np.random.default_rng(3).standard_normal((B, 3)) * 0.05, jnp.float32
    )
    carry = carry._replace(plant=carry.plant._replace(vel=vel))

    m = mesh_mod.scenario_mesh()
    fleet_step = rt.make_fleet_standing_step(
        horizon=4, opts=SolverOptions(al_iterations=1, ilqr_iterations=2)
    )
    sharded = mesh_mod.fleet_shard(fleet_step, m)
    carry_s = mesh_mod.shard_batch(carry, m)
    sp_s = mesh_mod.shard_batch(sp, m)
    joy_s = mesh_mod.shard_batch(joy, m)
    new_carry, metrics = jax.jit(sharded)(carry_s, sp_s, joy_s)
    jax.block_until_ready(new_carry)

    ref_carry, ref_metrics = jax.jit(fleet_step)(carry, sp, joy)
    np.testing.assert_allclose(
        np.array(new_carry.plant.pos), np.array(ref_carry.plant.pos), atol=1e-5
    )
    np.testing.assert_allclose(
        np.array(new_carry.plant.quat), np.array(ref_carry.plant.quat), atol=1e-5
    )
    assert float(metrics.alive) == B
    np.testing.assert_allclose(
        float(metrics.mpc_cost), float(jnp.sum(ref_metrics.mpc_cost)), rtol=1e-4
    )


def test_fleet_walking_shard_matches_single_device():
    """The WALKING fleet step — gait phase, foothold targets, and warm-start
    state all live in the sharded carry — over the mesh == one device
    (VERDICT r3 #7: standing-only sharding coverage was a gap). Runs 3 ticks
    so the gait state actually advances across the shard boundary."""
    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    carry1, sp1 = rt.init_walking_scenario(wts, dtype=dtype, warm_start=True)
    joy1 = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.3, dtype))
    B = 16
    tile = lambda t: jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), t)
    carry, sp, joy = tile(carry1), tile(sp1), tile(joy1)
    # per-scenario perturbation so shards differ
    vel = jnp.asarray(
        np.random.default_rng(7).standard_normal((B, 3)) * 0.03, dtype
    )
    carry = carry._replace(plant=carry.plant._replace(vel=vel))

    m = mesh_mod.scenario_mesh()
    fleet_step = rt.make_fleet_walking_step(
        horizon=4, opts=SolverOptions(al_iterations=1, ilqr_iterations=2)
    )
    sharded = jax.jit(mesh_mod.fleet_shard(fleet_step, m))
    ref_step = jax.jit(fleet_step)

    carry_s = mesh_mod.shard_batch(carry, m)
    sp_s = mesh_mod.shard_batch(sp, m)
    joy_s = mesh_mod.shard_batch(joy, m)
    ref_carry = carry
    for _ in range(3):
        carry_s, metrics = sharded(carry_s, sp_s, joy_s)
        ref_carry, ref_metrics = ref_step(ref_carry, sp, joy)
    jax.block_until_ready(carry_s)

    np.testing.assert_allclose(
        np.array(carry_s.plant.pos), np.array(ref_carry.plant.pos), atol=1e-5
    )
    np.testing.assert_allclose(
        np.array(carry_s.feet_world), np.array(ref_carry.feet_world), atol=1e-5
    )
    np.testing.assert_allclose(
        np.array(carry_s.gait.phase), np.array(ref_carry.gait.phase), atol=1e-6
    )
    assert float(metrics.alive) == B
    np.testing.assert_allclose(
        float(metrics.vel_err), float(jnp.sum(ref_metrics.vel_err)), rtol=1e-3
    )


def test_fleet_estimated_shard_matches_single_device():
    """The ESTIMATED fleet step — BasicKF state, per-scenario PRNG noise
    keys, gait phase, and terrain estimator all in the sharded carry — over
    the mesh == one device (VERDICT r4 #2: the DP axis must cover the full
    sensors→KF→MPC→plant pipeline, not just the ground-truth SRB tiers).
    Sensor noise is ON: the draws are keyed per scenario from the carried
    keys, so sharded and single-device runs see identical noise."""
    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    carry1, sp1 = rt.init_estimated_walking_scenario(wts, dtype=dtype, kf_type=1)
    joy1 = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.25, dtype))
    B = 16
    tile = lambda t: jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), t)
    carry, sp, joy = tile(carry1), tile(sp1), tile(joy1)
    vel = jnp.asarray(
        np.random.default_rng(11).standard_normal((B, 3)) * 0.03, dtype
    )
    carry = carry._replace(
        plant=carry.plant._replace(vel=vel),
        key=jax.random.split(jax.random.PRNGKey(42), B),
    )

    m = mesh_mod.scenario_mesh()
    fleet_step = rt.make_fleet_estimated_step(
        horizon=4, opts=SolverOptions(al_iterations=1, ilqr_iterations=2),
        kf_type=1, noise_acc=0.2, noise_gyro=0.02, noise_foot_vel=0.02,
        noise_foot_pos=0.003,
    )
    sharded = jax.jit(mesh_mod.fleet_shard(fleet_step, m))
    ref_step = jax.jit(fleet_step)

    carry_s = mesh_mod.shard_batch(carry, m)
    sp_s = mesh_mod.shard_batch(sp, m)
    joy_s = mesh_mod.shard_batch(joy, m)
    ref_carry = carry
    for _ in range(3):
        carry_s, metrics = sharded(carry_s, sp_s, joy_s)
        ref_carry, ref_metrics = ref_step(ref_carry, sp, joy)
    jax.block_until_ready(carry_s)

    np.testing.assert_allclose(
        np.array(carry_s.plant.pos), np.array(ref_carry.plant.pos), atol=1e-5
    )
    np.testing.assert_allclose(
        np.array(carry_s.est.x), np.array(ref_carry.est.x), atol=1e-4
    )
    assert float(metrics.alive) == B
    np.testing.assert_allclose(
        float(metrics.est_err), float(jnp.sum(ref_metrics.est_err)), rtol=1e-3
    )


def test_graft_dryrun():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)
