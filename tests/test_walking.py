"""Closed-loop trot walking: the full gait→Raibert→quat-MPC→plant pipeline
must track a commanded forward velocity without falling (the reference's
system test is manual joystick trotting in Gazebo, README.md:49-103 —
SURVEY.md §4c makes it an automated batched test)."""

import jax
import jax.numpy as jnp
import numpy as np

from quaternion_mpc_tpu.control import quat_mpc
from quaternion_mpc_tpu.runtime import step as rt
from quaternion_mpc_tpu.solver import SolverOptions
from quaternion_mpc_tpu.utils import config as cfg_mod


def test_trot_tracks_forward_velocity():
    dtype = jnp.float64
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    carry, sp = rt.init_walking_scenario(wts, dtype=dtype)
    joy = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.4, dtype))

    step = rt.make_walking_step(
        horizon=10, opts=SolverOptions(al_iterations=2, ilqr_iterations=4)
    )
    step_jit = jax.jit(step)

    vels, heights = [], []
    for _ in range(250):  # 2.5 s at h=10 ms
        carry, m = step_jit(carry, sp, joy)
        vels.append(float(carry.plant.vel[0]))
        heights.append(float(carry.plant.pos[2]))

    assert bool(carry.alive), "robot fell during trot"
    # average forward velocity over the last second tracks the command
    avg_vel = np.mean(vels[-100:])
    np.testing.assert_allclose(avg_vel, 0.4, atol=0.1)
    # height stays near target
    assert abs(np.mean(heights[-100:]) - 0.3) < 0.05
    # it actually moved
    assert float(carry.plant.pos[0]) > 0.5


def test_trot_fleet_vmap():
    """A small fleet of walking scenarios with different velocity commands."""
    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    carry1, sp1 = rt.init_walking_scenario(wts, dtype=dtype)
    B = 4
    tile = lambda t: jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), t)
    carry, sp = tile(carry1), tile(sp1)
    joy = tile(rt.neutral_joy(dtype))
    joy = joy._replace(velx=jnp.asarray([0.0, 0.2, 0.4, -0.2], dtype))

    step = rt.make_walking_step(
        horizon=6, opts=SolverOptions(al_iterations=1, ilqr_iterations=3)
    )
    vstep = jax.jit(jax.vmap(step))
    for _ in range(150):
        carry, m = vstep(carry, sp, joy)
    assert bool(jnp.all(carry.alive))
    x_final = np.array(carry.plant.pos[:, 0])
    # fastest forward command moved forward; backward command moved backward
    assert x_final[2] > 0.1
    assert x_final[3] < -0.02
    assert x_final[2] > x_final[0]


def test_rti_warm_start_tracks():
    """The bench's RTI latency mode (1 AL × 3 iLQR, warm-started across
    ticks — reference cross-tick warm start, QuatMpc.cpp:250-253) holds
    closed-loop trot tracking near the full 2×4 budget (measured: vel_err
    0.020 vs 0.014 m/s, height_err parity). 1×2 diverges — the budget
    floor is real, not padding."""
    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    opts = SolverOptions(al_iterations=1, ilqr_iterations=3, penalty_initial=10.0)
    carry, sp = rt.init_walking_scenario(wts, dtype=dtype, warm_start=True)
    joy = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.4, dtype))
    step = jax.jit(rt.make_walking_step(horizon=10, opts=opts, warm_start=True))
    vels, hs = [], []
    for _ in range(300):
        carry, m = step(carry, sp, joy)
        vels.append(float(m.vel_err))
        hs.append(float(m.height_err))
    assert bool(carry.alive), "RTI trot fell"
    assert float(carry.plant.pos[0]) > 0.9
    assert np.mean(vels[-150:]) < 0.05, f"vel_err {np.mean(vels[-150:]):.4f}"
    assert np.mean(hs[-150:]) < 0.01, f"height_err {np.mean(hs[-150:]):.4f}"


def test_crawl_gait_walks():
    """The crawl pattern table (LeggedContactFSM.cpp:152-193: one leg
    swinging at a time) closes the loop — in-loop coverage for the
    pattern, not just the unit-level table checks."""
    from quaternion_mpc_tpu.gait import schedule as sched

    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    pat = sched.crawl_pattern()
    carry, sp = rt.init_walking_scenario(wts, dtype=dtype, pattern=pat)
    joy = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.15, dtype))
    step = jax.jit(rt.make_walking_step(
        horizon=10, opts=SolverOptions(al_iterations=2, ilqr_iterations=4),
        pattern=pat, gait_freq=1.2,
    ))
    vels = []
    for _ in range(300):
        carry, m = step(carry, sp, joy)
        vels.append(float(m.vel_err))
    assert bool(carry.alive), "crawl fell"
    assert float(carry.plant.pos[0]) > 0.3
    assert np.mean(vels[-150:]) < 0.06
    assert abs(float(carry.plant.pos[2]) - 0.3) < 0.03


def test_trot_with_stand_gait_walks():
    """Trot-with-stand (all-stance dwell, LeggedContactFSM.cpp:110-150)
    closes the loop — the pattern the hardware loop uses for stoppable
    walking."""
    from quaternion_mpc_tpu.gait import schedule as sched

    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    pat = sched.trot_with_stand_pattern()
    carry, sp = rt.init_walking_scenario(wts, dtype=dtype, pattern=pat)
    joy = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.3, dtype))
    step = jax.jit(rt.make_walking_step(
        horizon=10, opts=SolverOptions(al_iterations=2, ilqr_iterations=4),
        pattern=pat, gait_freq=2.0,
    ))
    vels = []
    for _ in range(300):
        carry, m = step(carry, sp, joy)
        vels.append(float(m.vel_err))
    assert bool(carry.alive), "trot_with_stand fell"
    assert float(carry.plant.pos[0]) > 0.6
    assert np.mean(vels[-150:]) < 0.05


def test_rti_dual_warm_tracks():
    """Dual warm starting (carrying the AL multipliers across ticks, the
    other half of the real-time-iteration scheme) buys one more iteration:
    1 AL × 2 iLQR per tick — divergent with primal-only warm start — holds
    the trot (measured vel_err 0.041 vs 0.020 at 1×3). This is bench.py's
    dual-warm latency row."""
    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    opts = SolverOptions(al_iterations=1, ilqr_iterations=2, penalty_initial=10.0)
    carry, sp = rt.init_walking_scenario(wts, dtype=dtype, warm_start=True)
    joy = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.4, dtype))
    step = jax.jit(rt.make_walking_step(
        horizon=10, opts=opts, warm_start=True, dual_warm=True
    ))
    vels, hs = [], []
    for _ in range(300):
        carry, m = step(carry, sp, joy)
        vels.append(float(m.vel_err))
        hs.append(float(m.height_err))
    assert bool(carry.alive), "1x2 dual-warm trot fell"
    assert float(carry.plant.pos[0]) > 0.9
    assert np.mean(vels[-150:]) < 0.07, f"vel_err {np.mean(vels[-150:]):.4f}"
    assert np.mean(hs[-150:]) < 0.03, f"height_err {np.mean(hs[-150:]):.4f}"
