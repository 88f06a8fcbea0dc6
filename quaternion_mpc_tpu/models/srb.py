"""Single-rigid-body (SRB) dynamics for legged MPC, batched and jittable.

Two model families, mirroring the reference semantics (but re-derived as
vectorized jnp code with *data* parameters so every branch config — Go1 walk,
falling-cat airborne, spider-dog chimney, humanoid biped — is a parameter
choice, not new code):

- Quaternion SRB, body frame:  x = [p(3), q(4), v(3), ω(3)], u = (3·n_feet,)
  (reference: ``legged_ctrl/src/utils/AltroUtils.cpp:363-439`` 4-contact and
  ``:441-513`` 2-contact "trot" variants — here one function over any foot count)
- Euler SRB, world frame:      x = [rpy(3), p(3), ω(3), v(3)], u = (3·n_feet,)
  (reference: ``AltroUtils.cpp:224-359``)

Deliberate reference modeling choices preserved for fixture fidelity:
- no gyroscopic term ω×Iω (commented out at ``AltroUtils.cpp:390-391``),
- CoM-offset gravity moment uses the *trunk* mass (``:373-374``),
- gravity is rotated by a frozen per-solve rotation matrix parameter, NOT the
  state quaternion (``QuatMpc.cpp:184-189`` passes feedback attitude),
- the Euler Jacobian drops d(B·u)/dyaw and rows 6: wrt x (``:352-359``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from quaternion_mpc_tpu.ops import lie

GRAVITY = 9.81


class SrbParams(NamedTuple):
    """Frozen per-solve parameters of the SRB model (a pytree; batchable).

    foot_pos: (n_feet, 3) foot positions (body frame for the quat model,
        absolute/CoM frame for the Euler model).
    inertia: (3, 3) rigid-body inertia used in the MPC model.
    mass: total robot mass.
    com_offset: (3,) trunk CoM offset for the gravity moment.
    com_mass: mass used in the CoM gravity moment (reference uses trunk mass).
    rot_body_to_world: (3, 3) frozen attitude for gravity projection (quat
        model) / inertia rotation (Euler model).
    """

    foot_pos: jnp.ndarray
    inertia: jnp.ndarray
    mass: jnp.ndarray
    com_offset: jnp.ndarray
    com_mass: jnp.ndarray
    rot_body_to_world: jnp.ndarray

    @property
    def n_feet(self) -> int:
        return self.foot_pos.shape[-2]


def go1_params(
    foot_pos=None,
    inertia_scale: float = 12.84 / 5.204,
    mass: float = 12.84,
    rot_body_to_world=None,
    com_offset=(0.0223, 0.002, -0.0005),
    dtype=None,
) -> SrbParams:
    """Go1 constants (config/gazebo_go1_quat_mpc.yaml:115-122, QuatMpc.cpp:180-182)."""
    trunk_inertia = np.diag([0.0168128557, 0.063009565, 0.0716547275])
    if foot_pos is None:
        # default stance feet, body frame (TestAltroQuatMpc.cpp:41-44)
        foot_pos = np.array(
            [
                [0.2104, 0.13, -0.325],
                [0.2104, -0.13, -0.325],
                [-0.1658, 0.13, -0.325],
                [-0.1658, -0.13, -0.325],
            ]
        )
    if rot_body_to_world is None:
        rot_body_to_world = np.eye(3)
    if dtype is None:
        dtype = jnp.asarray(0.0).dtype  # canonical float for the current x64 mode
    return SrbParams(
        foot_pos=jnp.asarray(foot_pos, dtype=dtype),
        inertia=jnp.asarray(inertia_scale * trunk_inertia, dtype=dtype),
        mass=jnp.asarray(mass, dtype=dtype),
        com_offset=jnp.asarray(com_offset, dtype=dtype),
        com_mass=jnp.asarray(5.204, dtype=dtype),
        rot_body_to_world=jnp.asarray(rot_body_to_world, dtype=dtype),
    )


# ---------------------------------------------------------------------------
# Quaternion SRB (body frame): x = [p, q, v, ω]
# ---------------------------------------------------------------------------


def quat_srb_dynamics(x: jnp.ndarray, u: jnp.ndarray, p: SrbParams) -> jnp.ndarray:
    """Continuous-time quaternion SRB dynamics ẋ(x, u). Shapes: x (13,), u (3·n_feet,)."""
    q = x[3:7]
    v = x[7:10]
    omega = x[10:13]

    g_world = jnp.array([0.0, 0.0, -GRAVITY], dtype=x.dtype)
    g_body = p.rot_body_to_world.T @ g_world

    forces = u.reshape(-1, 3)  # (n_feet, 3), body frame
    total_force = jnp.sum(forces, axis=0)
    moment = jnp.sum(jnp.cross(p.foot_pos, forces), axis=0) + jnp.cross(
        p.com_offset, p.com_mass * g_body
    )

    p_dot = v
    q_dot = 0.5 * (lie.quat_G(q) @ omega)
    v_dot = total_force / p.mass + g_body
    omega_dot = jnp.linalg.solve(p.inertia, moment)
    return jnp.concatenate([p_dot, q_dot, v_dot, omega_dot])


def quat_srb_jacobian(x: jnp.ndarray, u: jnp.ndarray, p: SrbParams) -> jnp.ndarray:
    """Analytic Jacobian [∂ẋ/∂x, ∂ẋ/∂u] of `quat_srb_dynamics`, (13, 13+3·n_feet)."""
    del u  # dynamics are affine in u
    q = x[3:7]
    omega = x[10:13]
    dtype = x.dtype
    n_u = p.foot_pos.shape[-2] * 3

    A = jnp.zeros((13, 13), dtype=dtype)
    A = A.at[0:3, 7:10].set(jnp.eye(3, dtype=dtype))
    # dq̇/dq = ½ R([0, ω]) (right-multiplication matrix of the pure quaternion ω)
    omega_quat = jnp.concatenate([jnp.zeros((1,), dtype=dtype), omega])
    A = A.at[3:7, 3:7].set(0.5 * lie.quat_R(omega_quat))
    # dq̇/dω = ½ G(q)
    A = A.at[3:7, 10:13].set(0.5 * lie.quat_G(q))
    # (gyroscopic dω̇/dω intentionally omitted — reference AltroUtils.cpp:425)

    inertia_inv = jnp.linalg.inv(p.inertia)
    dvdot_du = jnp.tile(jnp.eye(3, dtype=dtype) / p.mass, (1, p.foot_pos.shape[-2]))
    # (3, 3·n_feet) block of I⁻¹·skew(r_i) per foot
    dwdot_du = jnp.einsum("ab,fbc->afc", inertia_inv, lie.skew(p.foot_pos)).reshape(3, n_u)

    B = jnp.zeros((13, n_u), dtype=dtype)
    B = B.at[7:10, :].set(dvdot_du)
    B = B.at[10:13, :].set(dwdot_du)
    return jnp.concatenate([A, B], axis=1)


# ---------------------------------------------------------------------------
# Euler SRB (world frame): x = [rpy, p, ω_world, v_world]
# ---------------------------------------------------------------------------


def _euler_srb_matrices(x: jnp.ndarray, p: SrbParams):
    dtype = x.dtype
    yaw = x[2]
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    # world angular velocity -> rpy rate (yaw-only approximation, AltroUtils.cpp:256-259)
    ang_vel_to_rpy = jnp.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], dtype=dtype)
    rot_z = jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=dtype)
    inertia_world = rot_z @ p.inertia @ rot_z.T
    inertia_world_inv = jnp.linalg.inv(inertia_world)

    n_feet = p.foot_pos.shape[-2]
    n_u = 3 * n_feet
    A = jnp.zeros((12, 12), dtype=dtype)
    A = A.at[0:3, 6:9].set(ang_vel_to_rpy)
    A = A.at[3:6, 9:12].set(jnp.eye(3, dtype=dtype))

    dwdot_du = jnp.einsum("ab,fbc->afc", inertia_world_inv, lie.skew(p.foot_pos)).reshape(3, n_u)
    B = jnp.zeros((12, n_u), dtype=dtype)
    B = B.at[6:9, :].set(dwdot_du)
    B = B.at[9:12, :].set(jnp.tile(jnp.eye(3, dtype=dtype) / p.mass, (1, n_feet)))
    return A, B


def euler_srb_dynamics(x: jnp.ndarray, u: jnp.ndarray, p: SrbParams) -> jnp.ndarray:
    """Continuous-time Euler SRB: ẋ = A(yaw)·x + B(yaw)·u + g. Shapes: x (12,)."""
    A, B = _euler_srb_matrices(x, p)
    g = jnp.zeros((12,), dtype=x.dtype).at[11].set(-GRAVITY)
    return A @ x + B @ u + g


# ---------------------------------------------------------------------------
# Fleet-native (batch-last) quaternion SRB: x (13, B), u (3·n_feet, B).
# Params broadcast on a trailing batch axis: foot_pos (n_feet, 3, B|1),
# inertia (3, 3, B|1), mass (B|1,), com_offset (3, B|1), rot (3, 3, B|1).
# See solver/fleet.py for why the fleet solver is batch-last.
# ---------------------------------------------------------------------------


def _inv3_bl(A):
    """Closed-form inverse of a (3, 3, B) stack (adjugate / det)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv = jnp.stack(
        [
            jnp.stack([A11, A12, A13]),
            jnp.stack([A21, A22, A23]),
            jnp.stack([A31, A32, A33]),
        ]
    )
    return inv / det


def _quat_G_bl(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack(
        [
            jnp.stack([-x, -y, -z]),
            jnp.stack([w, -z, y]),
            jnp.stack([z, w, -x]),
            jnp.stack([-y, x, w]),
        ]
    )


def params_to_fleet(p: SrbParams, batch_axis: bool = False) -> SrbParams:
    """Move per-scenario SrbParams (leading batch or unbatched) to batch-last.

    Unbatched params gain a trailing broadcast axis of size 1.
    """
    if batch_axis:
        move = lambda a: jnp.moveaxis(a, 0, -1)
    else:
        move = lambda a: a[..., None]
    return SrbParams(
        foot_pos=move(p.foot_pos),
        inertia=move(p.inertia),
        mass=move(jnp.atleast_1d(p.mass)) if not batch_axis else move(p.mass),
        com_offset=move(p.com_offset),
        com_mass=move(jnp.atleast_1d(p.com_mass)) if not batch_axis else move(p.com_mass),
        rot_body_to_world=move(p.rot_body_to_world),
    )


def quat_srb_dynamics_fleet(x: jnp.ndarray, u: jnp.ndarray, p: SrbParams) -> jnp.ndarray:
    """Batch-last quaternion SRB ẋ; x (13, B), u (3·n_feet, B) -> (13, B)."""
    q = x[3:7]
    v = x[7:10]
    omega = x[10:13]
    n_feet = p.foot_pos.shape[0]

    # g_body = Rᵀ g_world = -G·(row 2 of R); mul+sum form fuses
    g_body = -GRAVITY * p.rot_body_to_world[2]

    forces = u.reshape(n_feet, 3, -1)
    total_force = jnp.sum(forces, axis=0)
    moment = jnp.sum(jnp.cross(p.foot_pos, forces, axis=1), axis=0)
    moment = moment + jnp.cross(p.com_offset, p.com_mass * g_body, axis=0)

    p_dot = v
    q_dot = 0.5 * jnp.sum(_quat_G_bl(q) * omega[None, :, :], axis=1)
    v_dot = total_force / p.mass + g_body
    omega_dot = jnp.sum(_inv3_bl(p.inertia) * moment[None, :, :], axis=1)
    return jnp.concatenate([p_dot, q_dot, v_dot, omega_dot], axis=0)


def quat_srb_jacobian_fleet(x: jnp.ndarray, u: jnp.ndarray, p: SrbParams) -> jnp.ndarray:
    """Batch-last analytic Jacobian (13, 13+3·n_feet, B).

    Assembled scatter-free: every block is built by stack/concat of
    elementwise (B,)-vectors, so XLA lowers it to fused elementwise work
    instead of scatter ops (integer-array `.at[].set` lowers to scatter).
    """
    del u
    B = x.shape[-1]
    dtype = x.dtype
    q = x[3:7]
    omega = x[10:13]
    n_feet = p.foot_pos.shape[0]
    n_u = 3 * n_feet

    def zeros(*shape):
        return jnp.zeros(shape + (B,), dtype=dtype)

    def bcast(a, *shape):
        return jnp.broadcast_to(a, shape + (B,))

    # iota-built identity, constant-folded by XLA
    r3 = jax.lax.broadcasted_iota(jnp.int32, (3, 3), 0)
    c3 = jax.lax.broadcasted_iota(jnp.int32, (3, 3), 1)
    eye3 = (r3 == c3).astype(dtype)[..., None]  # (3, 3, 1)

    # rows 0-2 (ṗ = v): I₃ at cols 7-9
    top = jnp.concatenate(
        [zeros(3, 7), bcast(eye3, 3, 3), zeros(3, 3 + n_u)], axis=1
    )

    # rows 3-6 (q̇): ½R([0,ω]) at cols 3-6, ½G(q) at cols 10-12
    wx, wy, wz = omega[0], omega[1], omega[2]
    zero = jnp.zeros_like(wx)
    Rw = jnp.stack(
        [
            jnp.stack([zero, -wx, -wy, -wz]),
            jnp.stack([wx, zero, wz, -wy]),
            jnp.stack([wy, -wz, zero, wx]),
            jnp.stack([wz, wy, -wx, zero]),
        ]
    )
    qrows = jnp.concatenate(
        [
            zeros(4, 3),
            bcast(0.5 * Rw, 4, 4),
            zeros(4, 3),
            bcast(0.5 * _quat_G_bl(q), 4, 3),
            zeros(4, n_u),
        ],
        axis=1,
    )

    # rows 7-9 (v̇): I₃/m tiled per foot at cols 13+  (mass is (B,) or (1,1))
    dv_du = bcast(jnp.tile(eye3 * (1.0 / p.mass), (1, n_feet, 1)), 3, n_u)
    vrows = jnp.concatenate([zeros(3, 13), dv_du], axis=1)

    # rows 10-12 (ω̇): I⁻¹·skew(r_i) per foot at cols 13+3i
    inv_inertia = _inv3_bl(p.inertia)  # (3, 3, B|1)
    blks = []
    for i in range(n_feet):
        r = p.foot_pos[i]  # (3, B|1)
        rx, ry, rz = r[0], r[1], r[2]
        zz = jnp.zeros_like(rx)
        skew_r = jnp.stack(
            [
                jnp.stack([zz, -rz, ry]),
                jnp.stack([rz, zz, -rx]),
                jnp.stack([-ry, rx, zz]),
            ]
        )
        blk = jnp.sum(inv_inertia[:, :, None, :] * skew_r[None, :, :, :], axis=1)
        blks.append(bcast(blk, 3, 3))
    wrows = jnp.concatenate([zeros(3, 13)] + blks, axis=1)

    return jnp.concatenate([top, qrows, vrows, wrows], axis=0)


def quat_srb_error_discrete_jac_fleet(x, x1, u, p: SrbParams, h):
    """Error-state discrete Jacobians (Ae (12,12,B), Be (12,12·n_feet/4…,B))
    for the batch-last quaternion SRB under midpoint discretization,
    computed BLOCKWISE from the model's sparsity.

    Mathematically identical (exact algebra, not an approximation) to the
    generic path E(x1)ᵀ·[I + h·Am·(I + ½h·A)]·E(x) with A/Am the dense
    continuous Jacobians (`quat_srb_jacobian_fleet`) — but exploiting that
    the quat SRB's A has only three nonzero blocks (ṗ/∂v = I; q̇/∂q = ½R([0,ω]);
    q̇/∂ω = ½G(q); v̇ and ω̇ are state-independent, AltroUtils.cpp:363-439)
    and B is state-independent. The dense path builds two (13, 13+nu, B)
    Jacobians, two (13, 12, B) E-projections, and three 13-wide
    contractions per knot (~8k flops, ~10 slab materializations); the
    block form is ~600 flops on 4×4/4×3 tiles. At fleet batch sizes the
    cut in materialized intermediates (device-memory traffic) is the
    point.

    Derivation (midpoint, Ad = I + h·Am + ½h²·Am·A):
      Am·A rows 3:7 are the only nonzero rows: [½Rw_m·½Rw  at cols 3:7,
      ½Rw_m·½G at cols 10:13]; so with D_qq = I₄ + h·½Rw_m + ½h²·(½Rw_m·½Rw)
      and D_qω = h·½G_m + ½h²·(½Rw_m·½G):
        Ae = [[I₃, 0, h·I₃, 0],
              [0, G₁ᵀ·D_qq·G₀, 0, G₁ᵀ·D_qω],
              [0, 0, I₃, 0],
              [0, 0, 0, I₃]]
        Be = [[½h²·Bv], [G₁ᵀ·(½h²·½G_m·Bω)], [h·Bv], [h·Bω]]
      with Bv = (1/m)[I₃ …] and Bω = [I⁻¹·skew(rᵢ) …] the force rows.
    """
    dtype = x.dtype
    q = x[3:7]
    omega = x[10:13]
    n_feet = p.foot_pos.shape[0]
    n_u = 3 * n_feet

    # midpoint state pieces actually needed: q_m, ω_m
    g_body = -GRAVITY * p.rot_body_to_world[2]
    forces = u.reshape(n_feet, 3, -1)
    moment = jnp.sum(jnp.cross(p.foot_pos, forces, axis=1), axis=0)
    moment = moment + jnp.cross(p.com_offset, p.com_mass * g_body, axis=0)
    inv_inertia = _inv3_bl(p.inertia)
    omega_dot = jnp.sum(inv_inertia * moment[None, :, :], axis=1)
    q_dot = 0.5 * jnp.sum(_quat_G_bl(q) * omega[None, :, :], axis=1)
    q_m = q + 0.5 * h * q_dot
    w_m = omega + 0.5 * h * omega_dot

    def half_Rw(w):
        """½·R([0, w]) — the right-multiplication matrix of a pure-vector
        quaternion, (4, 4, B)."""
        wx, wy, wz = w[0], w[1], w[2]
        z = jnp.zeros_like(wx)
        return 0.5 * jnp.stack(
            [
                jnp.stack([z, -wx, -wy, -wz]),
                jnp.stack([wx, z, wz, -wy]),
                jnp.stack([wy, -wz, z, wx]),
                jnp.stack([wz, wy, -wx, z]),
            ]
        )

    mm = lambda A_, B_: jnp.sum(A_[:, :, None, :] * B_[None, :, :, :], axis=1)
    mtm = lambda A_, B_: jnp.sum(A_[:, :, None, :] * B_[:, None, :, :], axis=0)

    Qq = half_Rw(omega)
    Qq_m = half_Rw(w_m)
    Qw = 0.5 * _quat_G_bl(q)
    Qw_m = 0.5 * _quat_G_bl(q_m)
    G0 = _quat_G_bl(q)
    G1 = _quat_G_bl(x1[3:7])

    r4 = jax.lax.broadcasted_iota(jnp.int32, (4, 4), 0)
    c4 = jax.lax.broadcasted_iota(jnp.int32, (4, 4), 1)
    eye4 = (r4 == c4).astype(dtype)[..., None]
    r3 = jax.lax.broadcasted_iota(jnp.int32, (3, 3), 0)
    c3 = jax.lax.broadcasted_iota(jnp.int32, (3, 3), 1)
    eye3 = (r3 == c3).astype(dtype)[..., None]

    hh = 0.5 * h * h
    D_qq = eye4 + h * Qq_m + hh * mm(Qq_m, Qq)
    D_qw = h * Qw_m + hh * mm(Qq_m, Qw)
    A_phi = mtm(G1, mm(D_qq, G0))  # (3, 3, B)
    A_pw = mtm(G1, D_qw)           # (3, 3, B)

    B = x.shape[-1]
    z33 = jnp.zeros((3, 3, B), dtype=dtype)
    e33 = jnp.broadcast_to(eye3, (3, 3, B))
    he33 = jnp.broadcast_to(h * eye3, (3, 3, B))
    Ae = jnp.concatenate(
        [
            jnp.concatenate([e33, z33, he33, z33], axis=1),
            jnp.concatenate(
                [z33, jnp.broadcast_to(A_phi, (3, 3, B)),
                 z33, jnp.broadcast_to(A_pw, (3, 3, B))], axis=1
            ),
            jnp.concatenate([z33, z33, e33, z33], axis=1),
            jnp.concatenate([z33, z33, z33, e33], axis=1),
        ],
        axis=0,
    )

    # force rows (state-independent, quat_srb_jacobian_fleet rows 7-12)
    Bv = jnp.broadcast_to(
        jnp.tile(eye3 * (1.0 / p.mass), (1, n_feet, 1)), (3, n_u, B)
    )
    blks = []
    for i in range(n_feet):
        r = p.foot_pos[i]
        rx, ry, rz = r[0], r[1], r[2]
        zz = jnp.zeros_like(rx)
        skew_r = jnp.stack(
            [
                jnp.stack([zz, -rz, ry]),
                jnp.stack([rz, zz, -rx]),
                jnp.stack([-ry, rx, zz]),
            ]
        )
        blks.append(mm(inv_inertia, skew_r))
    Bw = jnp.broadcast_to(jnp.concatenate(blks, axis=1), (3, n_u, B))

    B_phi = mtm(G1, hh * mm(Qw_m, Bw))  # (3, n_u, B)
    Be = jnp.concatenate(
        [hh * Bv, jnp.broadcast_to(B_phi, (3, n_u, B)), h * Bv, h * Bw],
        axis=0,
    )
    return Ae, Be


class SrbEdjBlocks(NamedTuple):
    """Block decomposition of the quat-SRB error-state discrete Jacobians
    (see `quat_srb_error_discrete_jac_fleet` for the derivation):

        Ae = [[I, 0, h·I, 0],
              [0, A_phi, 0, A_pw],
              [0, 0, I, 0],
              [0, 0, 0, I]]
        Be = [[s_p·(1/m)[I…I]], [B_phi], [s_v·(1/m)[I…I]], [s_w·Bw]]

    The solver's structured Riccati step (`fleet.riccati_step`) consumes
    these directly — every product with Ae/Be is written against this
    sparsity instead of dense 12-wide contractions."""

    A_phi: jnp.ndarray   # (3, 3, B)
    A_pw: jnp.ndarray    # (3, 3, B)
    B_phi: jnp.ndarray   # (3, nu, B)
    Bw: jnp.ndarray      # (3, nu, B)
    inv_m: jnp.ndarray   # (B,) or (1,)
    h: jnp.ndarray       # scalar or (B,)
    s_p: jnp.ndarray     # ½h²
    s_v: jnp.ndarray     # h
    s_w: jnp.ndarray     # h


def quat_srb_edj_blocks(x, x1, u, p: SrbParams, h) -> SrbEdjBlocks:
    """Blocks of the error-state discrete Jacobians (midpoint). The dense
    assembly `quat_srb_error_discrete_jac_fleet` is exactly the blocks
    placed per the SrbEdjBlocks docstring (tested equal)."""
    dtype = x.dtype
    q = x[3:7]
    omega = x[10:13]
    n_feet = p.foot_pos.shape[0]

    g_body = -GRAVITY * p.rot_body_to_world[2]
    forces = u.reshape(n_feet, 3, -1)
    moment = jnp.sum(jnp.cross(p.foot_pos, forces, axis=1), axis=0)
    moment = moment + jnp.cross(p.com_offset, p.com_mass * g_body, axis=0)
    inv_inertia = _inv3_bl(p.inertia)
    omega_dot = jnp.sum(inv_inertia * moment[None, :, :], axis=1)
    q_dot = 0.5 * jnp.sum(_quat_G_bl(q) * omega[None, :, :], axis=1)
    q_m = q + 0.5 * h * q_dot
    w_m = omega + 0.5 * h * omega_dot

    def half_Rw(w):
        wx, wy, wz = w[0], w[1], w[2]
        z = jnp.zeros_like(wx)
        return 0.5 * jnp.stack(
            [
                jnp.stack([z, -wx, -wy, -wz]),
                jnp.stack([wx, z, wz, -wy]),
                jnp.stack([wy, -wz, z, wx]),
                jnp.stack([wz, wy, -wx, z]),
            ]
        )

    mm = lambda A_, B_: jnp.sum(A_[:, :, None, :] * B_[None, :, :, :], axis=1)
    mtm = lambda A_, B_: jnp.sum(A_[:, :, None, :] * B_[:, None, :, :], axis=0)

    Qq = half_Rw(omega)
    Qq_m = half_Rw(w_m)
    Qw = 0.5 * _quat_G_bl(q)
    Qw_m = 0.5 * _quat_G_bl(q_m)
    G0 = _quat_G_bl(q)
    G1 = _quat_G_bl(x1[3:7])

    r4 = jax.lax.broadcasted_iota(jnp.int32, (4, 4), 0)
    c4 = jax.lax.broadcasted_iota(jnp.int32, (4, 4), 1)
    eye4 = (r4 == c4).astype(dtype)[..., None]

    hh = 0.5 * h * h
    D_qq = eye4 + h * Qq_m + hh * mm(Qq_m, Qq)
    D_qw = h * Qw_m + hh * mm(Qq_m, Qw)
    A_phi = mtm(G1, mm(D_qq, G0))
    A_pw = mtm(G1, D_qw)

    blks = []
    for i in range(n_feet):
        r = p.foot_pos[i]
        rx, ry, rz = r[0], r[1], r[2]
        zz = jnp.zeros_like(rx)
        skew_r = jnp.stack(
            [
                jnp.stack([zz, -rz, ry]),
                jnp.stack([rz, zz, -rx]),
                jnp.stack([-ry, rx, zz]),
            ]
        )
        blks.append(mm(inv_inertia, skew_r))
    B = x.shape[-1]
    Bw = jnp.broadcast_to(jnp.concatenate(blks, axis=1), (3, 3 * n_feet, B))
    B_phi = mtm(G1, hh * mm(Qw_m, Bw))

    one = jnp.ones((), dtype)
    return SrbEdjBlocks(
        A_phi=A_phi, A_pw=A_pw, B_phi=jnp.broadcast_to(B_phi, Bw.shape),
        Bw=Bw, inv_m=1.0 / p.mass, h=h * one,
        s_p=hh * one, s_v=h * one, s_w=h * one,
    )


def euler_srb_jacobian(x: jnp.ndarray, u: jnp.ndarray, p: SrbParams) -> jnp.ndarray:
    """Reference-faithful approximate Jacobian (AltroUtils.cpp:352-359).

    Keeps d(rpy_rate)/dyaw and the constant blocks; drops d(B·u)/dyaw.
    """
    del u
    A, B = _euler_srb_matrices(x, p)
    dtype = x.dtype
    yaw = x[2]
    wx, wy = x[6], x[7]
    J = jnp.zeros((12, 12 + B.shape[1]), dtype=dtype)
    J = J.at[0, 2].set(wy * jnp.cos(yaw) - wx * jnp.sin(yaw))
    J = J.at[1, 2].set(-wx * jnp.cos(yaw) - wy * jnp.sin(yaw))
    J = J.at[0:6, 6:12].set(A[0:6, 6:12])
    J = J.at[6:12, 12:].set(B[6:12, :])
    return J


# ---------------------------------------------------------------------------
# Fleet-native (batch-last) Euler SRB: x (12, B), u (3·n_feet, B).
# Same layout conventions as the quaternion fleet model above.
# ---------------------------------------------------------------------------


def _rotz_bl(yaw):
    """(3, 3, B) yaw rotation from a (B,) yaw vector."""
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    z = jnp.zeros_like(yaw)
    one = jnp.ones_like(yaw)
    return jnp.stack(
        [
            jnp.stack([c, -s, z]),
            jnp.stack([s, c, z]),
            jnp.stack([z, z, one]),
        ]
    )


def _inv_inertia_world_bl(yaw, inertia):
    """Rz · I⁻¹ · Rzᵀ as a (3, 3, B) stack ((Rz I Rzᵀ)⁻¹)."""
    Rz = _rotz_bl(yaw)
    invI = _inv3_bl(jnp.broadcast_to(inertia, Rz.shape))
    tmp = jnp.sum(Rz[:, :, None, :] * invI[None, :, :, :], axis=1)  # Rz·I⁻¹
    return jnp.sum(tmp[:, :, None, :] * Rz.swapaxes(0, 1)[None, :, :, :], axis=1)


def euler_srb_dynamics_fleet(x: jnp.ndarray, u: jnp.ndarray, p: SrbParams) -> jnp.ndarray:
    """Batch-last Euler SRB ẋ (AltroUtils.cpp:224-293 semantics):
    x = [rpy, p, ω_world, v_world] (12, B), u (3·n_feet, B)."""
    yaw = x[2]
    omega = x[6:9]
    v = x[9:12]
    n_feet = p.foot_pos.shape[0]

    c, s = jnp.cos(yaw), jnp.sin(yaw)
    # yaw-only ang_vel → rpy-rate map (AltroUtils.cpp:256-259)
    rpy_rate = jnp.stack(
        [c * omega[0] + s * omega[1], -s * omega[0] + c * omega[1], omega[2]]
    )

    forces = u.reshape(n_feet, 3, -1)
    total_force = jnp.sum(forces, axis=0)
    moment = jnp.sum(jnp.cross(p.foot_pos, forces, axis=1), axis=0)
    inv_Iw = _inv_inertia_world_bl(yaw, p.inertia)
    omega_dot = jnp.sum(inv_Iw * moment[None, :, :], axis=1)

    g = jnp.zeros_like(v).at[2].set(-GRAVITY)
    v_dot = total_force / p.mass + g
    return jnp.concatenate([rpy_rate, v, omega_dot, v_dot], axis=0)


def euler_srb_jacobian_fleet(x: jnp.ndarray, u: jnp.ndarray, p: SrbParams) -> jnp.ndarray:
    """Batch-last reference-faithful approximate Jacobian (12, 12+n_u, B)
    matching `euler_srb_jacobian`: d(rpy_rate)/dyaw + constant A/B blocks,
    d(B·u)/dyaw dropped (AltroUtils.cpp:352-359). Scatter-free assembly."""
    del u
    B = x.shape[-1]
    dtype = x.dtype
    yaw = x[2]
    wx, wy = x[6], x[7]
    n_feet = p.foot_pos.shape[0]
    n_u = 3 * n_feet

    def zeros(*shape):
        return jnp.zeros(shape + (B,), dtype=dtype)

    def bcast(a, *shape):
        return jnp.broadcast_to(a, shape + (B,))

    c, s = jnp.cos(yaw), jnp.sin(yaw)
    zero = jnp.zeros_like(yaw)
    one = jnp.ones_like(yaw)
    # rows 0-2: d(rpy_rate)/dyaw at col 2, ang_vel_to_rpy at cols 6-9
    dyaw = jnp.stack([wy * c - wx * s, -wx * c - wy * s, zero])  # (3, B)
    ang_vel_to_rpy = jnp.stack(
        [
            jnp.stack([c, s, zero]),
            jnp.stack([-s, c, zero]),
            jnp.stack([zero, zero, one]),
        ]
    )
    rpy_rows = jnp.concatenate(
        [zeros(3, 2), dyaw[:, None, :], zeros(3, 3), ang_vel_to_rpy,
         zeros(3, 3 + n_u)],
        axis=1,
    )

    r3 = jax.lax.broadcasted_iota(jnp.int32, (3, 3), 0)
    c3 = jax.lax.broadcasted_iota(jnp.int32, (3, 3), 1)
    eye3 = (r3 == c3).astype(dtype)[..., None]
    # rows 3-5 (ṗ = v): I₃ at cols 9-11
    p_rows = jnp.concatenate(
        [zeros(3, 9), bcast(eye3, 3, 3), zeros(3, n_u)], axis=1
    )

    # rows 6-8 (ω̇): I_w⁻¹·skew(r_i) per foot at cols 12+3i
    inv_Iw = _inv_inertia_world_bl(yaw, p.inertia)
    blks = []
    for i in range(n_feet):
        r = jnp.broadcast_to(p.foot_pos[i], (3, B))
        rx, ry, rz = r[0], r[1], r[2]
        zz = jnp.zeros_like(rx)
        skew_r = jnp.stack(
            [
                jnp.stack([zz, -rz, ry]),
                jnp.stack([rz, zz, -rx]),
                jnp.stack([-ry, rx, zz]),
            ]
        )
        blks.append(jnp.sum(inv_Iw[:, :, None, :] * skew_r[None, :, :, :], axis=1))
    w_rows = jnp.concatenate([zeros(3, 12)] + blks, axis=1)

    # rows 9-11 (v̇): I₃/m per foot
    dv_du = bcast(jnp.tile(eye3 * (1.0 / p.mass), (1, n_feet, 1)), 3, n_u)
    v_rows = jnp.concatenate([zeros(3, 12), dv_du], axis=1)

    return jnp.concatenate([rpy_rows, p_rows, w_rows, v_rows], axis=0)
