"""Quaternion / SO(3) algebra as vectorized JAX ops.

Scalar-first convention ``q = [w, x, y, z]``. Every function broadcasts over
arbitrary leading batch axes and preserves the input dtype, so the same code
runs in f64 (fixture verification) and f32/bf16 (the speed path).

Semantics mirror the reference stack's hand-rolled quaternion algebra
(``legged_ctrl/src/utils/QuaternionUtils.cpp:10-53`` — cayley/inv-cayley maps,
Hamilton product via L(q), conjugate, attitude Jacobian G = L(q)·H — and the
SO(3)/Euler helpers in ``legged_ctrl/src/utils/Utils.cpp:7-105``), re-derived
as batched closed-form jnp expressions rather than per-element Eigen code.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# H maps R^3 into the "pure imaginary" quaternion subspace: H @ v = [0, v].
_H = np.zeros((4, 3))
_H[1:, :] = np.eye(3)


def H(dtype=None) -> jnp.ndarray:
    return jnp.asarray(_H, dtype=dtype)


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """Cross-product matrix: skew(v) @ u == cross(v, u). (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], axis=-1),
            jnp.stack([z, o, -x], axis=-1),
            jnp.stack([-y, x, o], axis=-1),
        ],
        axis=-2,
    )


def quat_L(q: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplication matrix: quat_L(q1) @ q2 == q1 ⊗ q2. (..., 4) -> (..., 4, 4)."""
    w = q[..., 0]
    v = q[..., 1:]
    top = jnp.concatenate([w[..., None], -v], axis=-1)[..., None, :]
    bottom_right = w[..., None, None] * jnp.eye(3, dtype=q.dtype) + skew(v)
    bottom = jnp.concatenate([v[..., None], bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def quat_R(q: jnp.ndarray) -> jnp.ndarray:
    """Right-multiplication matrix: quat_R(q2) @ q1 == q1 ⊗ q2."""
    w = q[..., 0]
    v = q[..., 1:]
    top = jnp.concatenate([w[..., None], -v], axis=-1)[..., None, :]
    bottom_right = w[..., None, None] * jnp.eye(3, dtype=q.dtype) - skew(v)
    bottom = jnp.concatenate([v[..., None], bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def quat_mult(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product q1 ⊗ q2, broadcasting over leading axes."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - jnp.sum(v1 * v2, axis=-1, keepdims=True)
    v = w1 * v2 + w2 * v1 + jnp.cross(v1, v2)
    return jnp.concatenate([w, v], axis=-1)


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_G(q: jnp.ndarray) -> jnp.ndarray:
    """Attitude Jacobian G(q) = L(q) @ H, (..., 4) -> (..., 4, 3).

    Maps body angular velocity to the quaternion tangent: q̇ = ½ G(q) ω.
    """
    w = q[..., 0]
    v = q[..., 1:]
    top = -v[..., None, :]
    bottom = w[..., None, None] * jnp.eye(3, dtype=q.dtype) + skew(v)
    return jnp.concatenate([top, bottom], axis=-2)


def cayley_map(phi: jnp.ndarray) -> jnp.ndarray:
    """Cayley (Rodrigues-parameter) chart: R^3 -> unit quaternion, phi=0 -> identity."""
    one = jnp.ones_like(phi[..., :1])
    q = jnp.concatenate([one, phi], axis=-1)
    return q / jnp.sqrt(1.0 + jnp.sum(phi * phi, axis=-1, keepdims=True))


def inv_cayley_map(q: jnp.ndarray) -> jnp.ndarray:
    """Inverse Cayley chart: unit quaternion -> R^3 (undefined at w=0)."""
    return q[..., 1:] / q[..., :1]


def quat_error(q: jnp.ndarray, q_ref: jnp.ndarray) -> jnp.ndarray:
    """3-parameter attitude error φ = inv_cayley(q_ref⁻¹ ⊗ q)."""
    return inv_cayley_map(quat_mult(quat_conj(q_ref), q))


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """Body→world rotation matrix of a unit quaternion. (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    one = jnp.ones_like(w)
    return jnp.stack(
        [
            jnp.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector v by quaternion q (body→world for attitude quats)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def euler_to_quat(euler: jnp.ndarray) -> jnp.ndarray:
    """ZYX (yaw-pitch-roll) Euler angles [roll, pitch, yaw] -> quaternion [w,x,y,z]."""
    r, p, y = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        axis=-1,
    )


def quat_to_euler(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion [w,x,y,z] -> ZYX Euler [roll, pitch, yaw]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ysqr = y * y
    roll = jnp.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + ysqr))
    t2 = jnp.clip(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = jnp.arcsin(t2)
    yaw = jnp.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (ysqr + z * z))
    return jnp.stack([roll, pitch, yaw], axis=-1)


def quat_to_rotvec(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Quaternion -> rotation vector (axis * angle)."""
    v = q[..., 1:]
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(n[..., 0], q[..., 0])[..., None]
    axis = jnp.where(n > eps, v / jnp.maximum(n, eps), jnp.zeros_like(v))
    return axis * angle


def rotz(yaw: jnp.ndarray) -> jnp.ndarray:
    """Rotation about z by yaw. (...,) -> (..., 3, 3)."""
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    o = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, o], axis=-1),
            jnp.stack([s, c, o], axis=-1),
            jnp.stack([o, o, one], axis=-1),
        ],
        axis=-2,
    )
