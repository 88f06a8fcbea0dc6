"""Quaternion MPC controller: assembles a `TrajOptProblem` from feedback +
command and extracts GRFs from the solution.

Semantics mirror ``legged_ctrl/src/mpc/QuatMpc.cpp:109-276`` (grf_update):
- reference build: body-frame position ramp from the filtered command,
  constant desired quaternion, filtered velocity reference, weight-split
  u_ref over planned contacts (:148-176);
- model: body-frame quaternion SRB with inertia = 1.2·I_trunk (:182) and the
  feedback attitude frozen into gravity projection (:184-189);
- friction pyramid rotated into the world frame: C·R(q)·u + b ≤ 0 with
  per-leg fz_max gating (:47-52, :194-215);
- x_init in body-centric coordinates (position zeroed); the reference's
  comma-typo at :242 makes initial ω always zero — kept behind
  ``zero_initial_omega`` (default True) for parity.

Unlike the reference (fresh ALTROSolver per tick, :218), problem assembly is
pure array work fused into the same jitted step as the solve.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from quaternion_mpc_tpu.control.types import Command, ControlOutput, RobotFeedback
from quaternion_mpc_tpu.models.srb import SrbParams, quat_srb_dynamics, quat_srb_jacobian
from quaternion_mpc_tpu.ops import lie
from quaternion_mpc_tpu.solver import (
    CostSpec,
    ModelSpec,
    SolverOptions,
    TrajOptProblem,
    make_solver,
)
from quaternion_mpc_tpu.utils import config as cfg_mod

GRAVITY = 9.81

# one leg's friction-pyramid rows (QuatMpc.cpp:47-52):
#   fx−μfz, −fx−μfz, fy−μfz, −fy−μfz, fz−fz_max, −fz  ≤ 0
_CONE = np.array(
    [
        [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
    ]
)
_CONE_MU = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 0.0])


def cone_matrix(mu, dtype):
    C = jnp.asarray(_CONE, dtype=dtype)
    return C.at[:, 2].add(-mu * jnp.asarray(_CONE_MU, dtype=dtype))


def cone_matrix_with_normal(mu, normal, fz_max_row: bool = True):
    """Friction-pyramid rows for a contact with surface normal ``normal``
    (the ``spider_dog`` chimney-climb configs: non-flat contact normals,
    BASELINE.json configs; flat ground ``normal=ẑ`` reduces to `cone_matrix`).

    Builds a tangent basis (t1, t2) ⊥ n and returns (6, 3) rows
    [±t1 − μn; ±t2 − μn; n; −n] so that C·f + b ≤ 0 encodes
    |f·t| ≤ μ(f·n), 0 ≤ f·n ≤ f_max.
    """
    n = normal / jnp.linalg.norm(normal, axis=-1, keepdims=True)
    # tangent basis: pick the world axis least aligned with n
    ref = jnp.where(
        jnp.abs(n[..., 2:3]) < 0.9,
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], dtype=n.dtype), n.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype=n.dtype), n.shape),
    )
    t1 = jnp.cross(ref, n)
    t1 = t1 / jnp.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = jnp.cross(n, t1)
    return jnp.stack(
        [t1 - mu * n, -t1 - mu * n, t2 - mu * n, -t2 - mu * n, n, -n], axis=-2
    )


class QuatMpcWeights(NamedTuple):
    """Numeric controller parameters (pytree; batchable for scenario sweeps)."""

    Qd: jnp.ndarray          # (13,)
    Rd: jnp.ndarray          # (12,)
    w: jnp.ndarray
    mu: jnp.ndarray
    fz_max: jnp.ndarray
    mass: jnp.ndarray
    trunk_mass: jnp.ndarray
    inertia: jnp.ndarray     # (3,3) MPC model inertia (1.2·I_trunk)
    com_offset: jnp.ndarray  # (3,)
    h: jnp.ndarray           # seconds


def weights_from_config(cfg: cfg_mod.FrameworkConfig, dtype=jnp.float32) -> QuatMpcWeights:
    m = cfg.mpc
    r = cfg.robot
    return QuatMpcWeights(
        Qd=jnp.asarray(m.q_weights, dtype=dtype),
        Rd=jnp.asarray(m.r_weights, dtype=dtype),
        w=jnp.asarray(m.w, dtype=dtype),
        mu=jnp.asarray(m.mu, dtype=dtype),
        fz_max=jnp.asarray(m.fz_max, dtype=dtype),
        mass=jnp.asarray(r.mass, dtype=dtype),
        trunk_mass=jnp.asarray(r.trunk_mass, dtype=dtype),
        inertia=jnp.asarray(1.2 * np.diag(r.trunk_inertia), dtype=dtype),
        com_offset=jnp.asarray(r.com_offset, dtype=dtype),
        h=jnp.asarray(m.update_period_ms / 1000.0, dtype=dtype),
    )


MODEL_SPEC = ModelSpec(
    nx=13, nu=12, f=quat_srb_dynamics, fj=quat_srb_jacobian, quat_idx=3
)


def build_problem(
    fbk: RobotFeedback,
    cmd: Command,
    wts: QuatMpcWeights,
    horizon: int,
    zero_initial_omega: bool = True,
) -> TrajOptProblem:
    dtype = fbk.torso_quat.dtype
    n_feet = fbk.foot_pos_body.shape[-2]
    rot = lie.quat_to_rotmat(fbk.torso_quat)

    # references over the horizon (QuatMpc.cpp:148-176). cmd.contacts is
    # either (n_feet,) — one schedule tiled over the horizon, the reference
    # behavior (ConvexMpc.cpp:82 TODO) — or (N+1, n_feet) per-knot from
    # gait.predict_contact_state, so the MPC sees upcoming stance switches.
    contacts_k = jnp.broadcast_to(cmd.contacts, (horizon + 1, n_feet))
    num_contacts = jnp.maximum(jnp.sum(contacts_k, axis=-1, keepdims=True), 1.0)
    fz_share = contacts_k * wts.mass * GRAVITY / num_contacts  # (N+1, n_feet)
    u_ref = jnp.concatenate(
        [jnp.zeros((horizon + 1, n_feet, 2), dtype=dtype), fz_share[..., None]],
        axis=-1,
    ).reshape(horizon + 1, -1)

    steps = jnp.arange(horizon + 1, dtype=dtype)[:, None]
    pos_ref = cmd.pos_body_d + cmd.lin_vel_body_d * steps * wts.h
    pos_ref = pos_ref.at[:, 2].set(cmd.pos_body_d[2])
    quat_ref = jnp.tile(cmd.quat_d, (horizon + 1, 1))
    vel_ref = jnp.tile(cmd.lin_vel_body_d, (horizon + 1, 1))
    omega_ref = jnp.zeros((horizon + 1, 3), dtype=dtype)  # :172 commented out
    x_ref = jnp.concatenate([pos_ref, quat_ref, vel_ref, omega_ref], axis=-1)

    params = SrbParams(
        foot_pos=fbk.foot_pos_body,
        inertia=wts.inertia,
        mass=wts.mass,
        com_offset=wts.com_offset,
        com_mass=wts.trunk_mass,
        rot_body_to_world=rot,
    )

    # friction pyramid in world frame: C·R·u_leg + b ≤ 0 (QuatMpc.cpp:194-215)
    C_world = cone_matrix(wts.mu, dtype) @ rot  # (6, 3)
    Cu = jnp.kron(jnp.eye(n_feet, dtype=dtype), C_world)
    if cmd.contacts.ndim == 1:
        cb = jnp.zeros((6 * n_feet,), dtype=dtype)
        cb = cb.at[4::6].set(-wts.fz_max * cmd.contacts)
    else:
        cb = jnp.zeros((horizon + 1, 6 * n_feet), dtype=dtype)
        cb = cb.at[:, 4::6].set(-wts.fz_max * contacts_k)

    v_body = rot.T @ fbk.torso_lin_vel_world
    omega0 = jnp.zeros((3,), dtype=dtype) if zero_initial_omega else fbk.torso_ang_vel_body
    x0 = jnp.concatenate(
        [jnp.zeros((3,), dtype=dtype), fbk.torso_quat, v_body, omega0]
    )

    return TrajOptProblem(
        x0=x0,
        cost=CostSpec(Qd=wts.Qd, Rd=wts.Rd, w=wts.w, x_ref=x_ref, u_ref=u_ref),
        Cu=Cu,
        cb=cb,
        h=wts.h,
        params=params,
        us_init=u_ref[:horizon],
    )


# ---------------------------------------------------------------------------
# Fleet-native (batch-last) path — the fleet throughput path (solver/fleet.py)
# ---------------------------------------------------------------------------


def build_fleet_problem(fbk, cmd, wts, horizon: int, zero_initial_omega: bool = True):
    """Batch-first (fbk, cmd, wts) pytrees -> batch-last FleetProblem.

    The transposes happen once at the solve boundary; everything inside the
    solver then runs with the scenario batch as the last (minor) axis.
    """
    import jax

    from quaternion_mpc_tpu.models import srb as srb_mod
    from quaternion_mpc_tpu.solver.fleet import FleetProblem

    prob_bf = jax.vmap(
        lambda f, c, w: build_problem(f, c, w, horizon, zero_initial_omega)
    )(fbk, cmd, wts)

    bl = lambda a: jnp.moveaxis(a, 0, -1)
    return FleetProblem(
        x0=bl(prob_bf.x0),
        x_ref=jnp.moveaxis(prob_bf.cost.x_ref, 0, -1),
        u_ref=jnp.moveaxis(prob_bf.cost.u_ref, 0, -1),
        Qd=bl(prob_bf.cost.Qd),
        Rd=bl(prob_bf.cost.Rd),
        w=prob_bf.cost.w,
        Cu=bl(prob_bf.Cu),
        cb=bl(prob_bf.cb),
        h=prob_bf.h,
        params=srb_mod.params_to_fleet(prob_bf.params, batch_axis=True),
        us_init=jnp.moveaxis(prob_bf.us_init, 0, -1),
    )


FLEET_MODEL_SPEC = None  # created lazily to avoid import cycle


def _fleet_spec():
    global FLEET_MODEL_SPEC
    if FLEET_MODEL_SPEC is None:
        from quaternion_mpc_tpu.models.srb import (
            quat_srb_dynamics_fleet,
            quat_srb_error_discrete_jac_fleet,
            quat_srb_jacobian_fleet,
        )
        from quaternion_mpc_tpu.solver.fleet import FleetModelSpec

        FLEET_MODEL_SPEC = FleetModelSpec(
            nx=13,
            nu=12,
            f=quat_srb_dynamics_fleet,
            fj=quat_srb_jacobian_fleet,
            quat_idx=3,
            integrator="midpoint",
            edj=quat_srb_error_discrete_jac_fleet,
            # edj_blocks (quat_srb_edj_blocks) deliberately NOT wired:
            # writing the sweep's Q-terms against the block sparsity
            # (fleet._structured_q_terms) needs a 4-piece concat/tile
            # assembly that materialises more slabs than the fused dense
            # reduce_sum chain over the structured-edj Ae/Be moves. Whether
            # that holds on the H100 is unmeasured.
        )
    return FLEET_MODEL_SPEC


def make_fleet_controller(
    horizon: int,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=5),
    zero_initial_omega: bool = True,
    return_body: bool = False,
    backend: str = "auto",
    return_sol: bool = False,
):
    """Batch-last grf_update over a whole fleet at once.

    Takes batch-FIRST (fbk, cmd, wts) pytrees (natural user layout), returns
    (grf_world (B, n_feet, 3), cost (B,)); with return_body=True returns
    (grf_world, grf_body, cost); with return_sol=True additionally the raw
    batch-last FleetSolution (for cross-tick warm-start carries). ``backend``
    selects the Riccati sweep (solver/fleet.py make_fleet_solver): "assoc"
    is the horizon-parallel associative-scan pass for small-batch latency.

    ``grf_update`` accepts optional batch-FIRST warm starts — ``us_init``
    (B, N, nu) primals and ``lam_init`` (B, N, nc) AL multipliers — the
    fleet-wide equivalent of the reference's SetState/SetInput cross-tick
    warm starting (QuatMpc.cpp:250-253); the transpose to the solver's
    batch-last layout happens here at the boundary.
    """
    from quaternion_mpc_tpu.ops import lie as lie_mod
    from quaternion_mpc_tpu.solver.fleet import make_fleet_solver

    solver = make_fleet_solver(_fleet_spec(), opts, backend=backend)

    def grf_update(fbk, cmd, wts, us_init=None, lam_init=None):
        prob = build_fleet_problem(fbk, cmd, wts, horizon, zero_initial_omega)
        if us_init is not None:
            prob = prob._replace(us_init=jnp.moveaxis(us_init, 0, -1))
        if lam_init is not None:
            prob = prob._replace(lam_init=jnp.moveaxis(lam_init, 0, -1))
        sol = solver(prob)
        u0 = jnp.moveaxis(sol.us[0], -1, 0)  # (B, 12)
        grf_body = u0.reshape(u0.shape[0], -1, 3)
        rot = lie_mod.quat_to_rotmat(fbk.torso_quat)  # (B, 3, 3)
        grf_world = jnp.einsum("bij,bfj->bfi", rot, grf_body)
        out = (grf_world, grf_body, sol.cost) if return_body else (grf_world, sol.cost)
        if return_sol:
            return out + (sol,)
        return out

    return grf_update


def make_controller(
    horizon: int,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=5),
    zero_initial_omega: bool = True,
):
    """Returns grf_update(fbk, cmd, wts[, us_init]) -> (ControlOutput, Solution).

    Solver budget default mirrors the online config (iterations_max=10 at
    QuatMpc.cpp:22 — here 2 AL × 5 iLQR); jit/vmap the returned callable.
    ``us_init``: optional (N, 12) input warm start — pass the previous
    tick's ``sol.us`` for the reference's cross-tick warm starting
    (SetState/SetInput, QuatMpc.cpp:250-253), which lets a reduced
    iteration budget (RTI-style, e.g. 1 AL × 3) hold tracking quality.
    """
    solver = make_solver(MODEL_SPEC, opts)

    def grf_update(fbk: RobotFeedback, cmd: Command, wts: QuatMpcWeights,
                   us_init=None, lam_init=None):
        prob = build_problem(fbk, cmd, wts, horizon, zero_initial_omega)
        if us_init is not None:
            prob = prob._replace(us_init=us_init)
        if lam_init is not None:
            prob = prob._replace(lam_init=lam_init)
        sol = solver(prob)
        rot = lie.quat_to_rotmat(fbk.torso_quat)
        grf_body = sol.us[0].reshape(-1, 3)
        out = ControlOutput(
            grf_body=grf_body,
            grf_world=grf_body @ rot.T,
            foot_pos_target_world=jnp.zeros_like(fbk.foot_pos_body),
            foot_vel_target_world=jnp.zeros_like(fbk.foot_pos_body),
            mpc_cost=sol.stats.cost,
            mpc_iterations=sol.stats.iterations,
        )
        return out, sol

    return grf_update


# LeggedMpc::terrain_update parity (abstract hook at LeggedMpc.h:21-49;
# QuatMpc's implementation at QuatMpc.cpp:307-335): fit the walking surface
# from stance footholds, adapt the desired pitch. Pure-function form lives in
# kin.terrain; re-exported here as the controller-API surface.
from quaternion_mpc_tpu.kin.terrain import (  # noqa: E402,F401
    TerrainState,
    init_terrain_state,
    terrain_update,
)
