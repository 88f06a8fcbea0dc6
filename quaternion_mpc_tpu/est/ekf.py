"""Contact-aided EKF: IMU propagation + leg odometry + optional mocap update.

The equivalent of the reference's CasADi-codegen estimator submodule
(``ShuoYangRobotics/legged-kalman-filter`` via ``.gitmodules:1-3``; consumed
through ``A1SensorData``/``A1KFCombineLOWithFootTerrain`` at
``BaseInterface.cpp:52-68, 302-338`` and mocap inputs at
``HardwareInterface.cpp:183-214``). The submodule is not vendored in the
snapshot, so this is a fresh derivation with the same interface shape:
noise parameters from the YAML config (``gazebo_go1_convex_mpc.yaml:111-126``),
``input_imu/input_leg`` style inputs, and only ``v_world`` consumed by default
(``BaseInterface.cpp:330-337``).

State (21): [p(3), v(3), rpy(3), foot_world(4×3)]. Process: IMU mechanization
(body acc rotated by the estimated attitude, gyro → Euler rates). Updates:
per-leg FK position residual, leg-odometry velocity, foot height, optional
mocap (position + yaw). Jacobians by forward-mode autodiff — the JAX-native
replacement for CasADi codegen.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from quaternion_mpc_tpu.ops import lie

NUM_LEG = 4
STATE_SIZE = 21
GRAVITY = 9.81


class EkfNoise(NamedTuple):
    """Values: config/gazebo_go1_convex_mpc.yaml:111-126 (LeggedState.cpp defaults)."""

    initial_cov: float = 0.001
    process_pos_xy: float = 0.001
    process_pos_z: float = 0.001
    process_vel_xy: float = 0.001
    process_vel_z: float = 0.001
    process_rot: float = 1e-6
    process_foot: float = 1e-4
    measure_fk: float = 0.01
    measure_vel: float = 1.0
    measure_height: float = 0.1
    opti_pos: float = 0.001
    opti_vel: float = 999.0
    opti_yaw: float = 0.01


class EkfState(NamedTuple):
    x: jnp.ndarray  # (21,)
    P: jnp.ndarray  # (21, 21)


class EkfInputs(NamedTuple):
    torso_lin_acc_body: jnp.ndarray  # (3,)
    torso_ang_vel_body: jnp.ndarray  # (3,)
    foot_pos_body: jnp.ndarray       # (4,3)
    foot_lin_vel_rel: jnp.ndarray    # (4,3)
    contacts: jnp.ndarray            # (4,)


def init_state(
    torso_pos_world, torso_euler, foot_pos_body, noise: EkfNoise = EkfNoise()
) -> EkfState:
    dtype = torso_pos_world.dtype
    rot = lie.quat_to_rotmat(lie.euler_to_quat(torso_euler))
    feet = foot_pos_body @ rot.T + torso_pos_world
    x = jnp.concatenate(
        [torso_pos_world, jnp.zeros((3,), dtype=dtype), torso_euler, feet.reshape(-1)]
    )
    return EkfState(x=x, P=noise.initial_cov * jnp.eye(STATE_SIZE, dtype=dtype))


def _process(x, acc_body, gyro_body, dt):
    p, v, rpy = x[0:3], x[3:6], x[6:9]
    rot = lie.quat_to_rotmat(lie.euler_to_quat(rpy))
    acc_world = rot @ acc_body + jnp.array([0.0, 0.0, -GRAVITY], dtype=x.dtype)
    # ZYX Euler kinematics: rpy_rate = T(rpy) · ω_body
    r, pt = rpy[0], rpy[1]
    sr, cr = jnp.sin(r), jnp.cos(r)
    cp = jnp.maximum(jnp.cos(pt), 1e-6)
    tp = jnp.tan(pt)
    T = jnp.array(
        [
            [1.0, sr * tp, cr * tp],
            [0.0, cr, -sr],
            [0.0, sr / cp, cr / cp],
        ],
        dtype=x.dtype,
    )
    rpy_rate = T @ gyro_body
    return jnp.concatenate(
        [
            p + dt * v + 0.5 * dt * dt * acc_world,
            v + dt * acc_world,
            rpy + dt * rpy_rate,
            x[9:],  # feet are stationary in the process model
        ]
    )


def _measure(x, foot_pos_body_flat):
    """h(x): per-leg [foot_world − p in body frame residual source], leg
    heights; velocity measurement is handled directly (linear in v)."""
    p, rpy = x[0:3], x[6:9]
    rot = lie.quat_to_rotmat(lie.euler_to_quat(rpy))
    feet = x[9:].reshape(NUM_LEG, 3)
    fk_pred = (feet - p) @ rot  # body-frame prediction of FK
    heights = feet[:, 2]
    del foot_pos_body_flat
    return jnp.concatenate([fk_pred.reshape(-1), heights])


def update(
    state: EkfState,
    inp: EkfInputs,
    dt,
    noise: EkfNoise = EkfNoise(),
    foot_height_ref=None,
) -> Tuple[EkfState, jnp.ndarray, jnp.ndarray]:
    """IMU propagate + leg-odometry update. Returns (state, p_world, v_world).

    ``foot_height_ref``: optional (4,) expected ground height per foot —
    the terrain-aware measurement of the reference's
    ``A1KFCombineLOWithFootTerrain`` submodule variant (flat ground = 0,
    the default)."""
    dtype = state.x.dtype
    contact = inp.contacts

    # --- propagate
    F = jax.jacfwd(_process)(state.x, inp.torso_lin_acc_body, inp.torso_ang_vel_body, dt)
    x_pred = _process(state.x, inp.torso_lin_acc_body, inp.torso_ang_vel_body, dt)
    q_diag = jnp.concatenate(
        [
            jnp.array(
                [noise.process_pos_xy, noise.process_pos_xy, noise.process_pos_z],
                dtype=dtype,
            ),
            jnp.array(
                [noise.process_vel_xy, noise.process_vel_xy, noise.process_vel_z],
                dtype=dtype,
            ),
            jnp.full((3,), noise.process_rot, dtype),
            jnp.repeat(1.0 + (1.0 - contact) * 1e3, 3) * noise.process_foot,
        ]
    )
    P_pred = F @ state.P @ F.T + dt * jnp.diag(q_diag)

    # --- measurement: FK residual (12) + foot height (4) + leg velocity (3·4)
    h_fn = lambda x: _measure(x, None)
    H_nl = jax.jacfwd(h_fn)(x_pred)
    z_pred_nl = h_fn(x_pred)
    href = (
        jnp.zeros((NUM_LEG,), dtype=dtype)
        if foot_height_ref is None else foot_height_ref
    )
    z_nl = jnp.concatenate([inp.foot_pos_body.reshape(-1), href])

    # leg-odometry velocity: v ≈ −R(ω×r + J dq) for contact legs
    rpy = x_pred[6:9]
    rot = lie.quat_to_rotmat(lie.euler_to_quat(rpy))
    leg_v_body = -inp.foot_lin_vel_rel - jnp.cross(
        jnp.broadcast_to(inp.torso_ang_vel_body, (NUM_LEG, 3)), inp.foot_pos_body
    )
    v_meas = leg_v_body @ rot.T  # (4,3) world
    H_v = jnp.zeros((NUM_LEG * 3, STATE_SIZE), dtype=dtype)
    H_v = H_v.at[:, 3:6].set(jnp.tile(jnp.eye(3, dtype=dtype), (NUM_LEG, 1)))

    H = jnp.concatenate([H_nl, H_v], axis=0)
    z = jnp.concatenate([z_nl, v_meas.reshape(-1)])
    z_pred = jnp.concatenate([z_pred_nl, jnp.tile(x_pred[3:6], NUM_LEG)])

    infl = 1.0 + (1.0 - contact) * 1e3
    r_diag = jnp.concatenate(
        [
            jnp.repeat(infl, 3) * noise.measure_fk,
            infl * noise.measure_height,
            jnp.repeat(infl, 3) * noise.measure_vel,
        ]
    )
    S = H @ P_pred @ H.T + jnp.diag(r_diag)
    S = 0.5 * (S + S.T)
    K = jnp.linalg.solve(S, H @ P_pred).T
    x_new = x_pred + K @ (z - z_pred)
    P_new = (jnp.eye(STATE_SIZE, dtype=dtype) - K @ H) @ P_pred
    P_new = 0.5 * (P_new + P_new.T)
    new_state = EkfState(x=x_new, P=P_new)
    return new_state, x_new[0:3], x_new[3:6]


def mocap_update(
    state: EkfState,
    mocap_pos_world: jnp.ndarray,
    mocap_yaw: jnp.ndarray,
    noise: EkfNoise = EkfNoise(),
) -> EkfState:
    """Optional mocap fusion (update_filter_with_opti analog,
    HardwareInterface.cpp:204-207): position + yaw observation."""
    dtype = state.x.dtype
    H = jnp.zeros((4, STATE_SIZE), dtype=dtype)
    H = H.at[0:3, 0:3].set(jnp.eye(3, dtype=dtype))
    H = H.at[3, 8].set(1.0)
    z = jnp.concatenate([mocap_pos_world, mocap_yaw[None]])
    z_pred = jnp.concatenate([state.x[0:3], state.x[8:9]])
    r_diag = jnp.array(
        [noise.opti_pos, noise.opti_pos, noise.opti_pos, noise.opti_yaw], dtype=dtype
    )
    S = H @ state.P @ H.T + jnp.diag(r_diag)
    K = jnp.linalg.solve(0.5 * (S + S.T), H @ state.P).T
    x_new = state.x + K @ (z - z_pred)
    P_new = (jnp.eye(STATE_SIZE, dtype=dtype) - K @ H) @ state.P
    return EkfState(x=x_new, P=0.5 * (P_new + P_new.T))
