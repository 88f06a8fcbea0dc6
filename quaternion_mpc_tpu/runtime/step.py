"""The fused control step: goal → (gait) → MPC solve → force application →
plant, as ONE pure function ``step(carry, cmd) -> (carry, metrics)``.

This collapses the reference's three mutex-coupled SCHED_FIFO threads
(``Main.cpp:88-207``: MPC @200 Hz, low-level @4 kHz, feedback @1 kHz) into a
single compiled step; the rate hierarchy becomes substep counts
(``LeggedParams.h:4-6``). `jax.vmap` over scenarios gives the fleet axis;
`parallel.mesh.fleet_map` shards it over chips.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quaternion_mpc_tpu.control import goals, quat_mpc, safety
from quaternion_mpc_tpu.control.types import Command, RobotFeedback
from quaternion_mpc_tpu.ops import lie
from quaternion_mpc_tpu.sim import plant
from quaternion_mpc_tpu.solver import SolverOptions


class ScenarioCarry(NamedTuple):
    plant: plant.PlantState
    goal: goals.GoalState
    alive: jnp.ndarray  # bool — scenario not tripped/diverged


class StepMetrics(NamedTuple):
    mpc_cost: jnp.ndarray
    height_err: jnp.ndarray
    att_err: jnp.ndarray
    alive: jnp.ndarray


class ScenarioParams(NamedTuple):
    """Per-scenario randomizable parameters (a pytree → domain randomization).

    terrain: optional `sim.terrain.TerrainParams` world for the walking
    steps (None → flat ground). Per-scenario data, so a fleet can mix flat/
    slope/stairs worlds (`TerrainParams.kind` is traced)."""

    wts: quat_mpc.QuatMpcWeights
    plant_params: plant.PlantParams
    target_height: jnp.ndarray
    terrain: "object" = None
    rho_fix: "object" = None      # (4, 5) leg geometry (None -> Go1)
    default_rel: "object" = None  # (4, 3) neutral stance feet (None -> Go1)


def feedback_from_plant(ps: plant.PlantState, foot_pos_body) -> RobotFeedback:
    """Ground-truth feedback (kf_type=0 path, GazeboInterface.cpp:136-149)."""
    n_feet = foot_pos_body.shape[-2]
    dtype = ps.pos.dtype
    return RobotFeedback(
        torso_pos_world=ps.pos,
        torso_quat=ps.quat,
        torso_lin_vel_world=ps.vel,
        torso_ang_vel_body=ps.omega,
        foot_pos_body=foot_pos_body,
        foot_contact=jnp.ones((n_feet,), dtype=dtype),
        joint_pos=jnp.zeros((n_feet * 3,), dtype=dtype),
        joint_vel=jnp.zeros((n_feet * 3,), dtype=dtype),
    )


GO1_DEFAULT_REL = (
    (0.20, 0.14, -0.3), (0.20, -0.14, -0.3),
    (-0.20, 0.14, -0.3), (-0.20, -0.14, -0.3),
)


def _sp_rho_fix(sp, dtype):
    from quaternion_mpc_tpu.kin import leg as leg_mod

    rho = getattr(sp, "rho_fix", None)
    return leg_mod.go1_rho_fix(dtype) if rho is None else rho


def _sp_default_rel(sp, dtype):
    rel = getattr(sp, "default_rel", None)
    if rel is None:
        return jnp.asarray(GO1_DEFAULT_REL, dtype=dtype)
    return rel


def _pinned_feet_joint_state(ps, foot_pos_body, foot_vel_world, rho_fix):
    """Joint angles AND velocities consistent with the pinned-feet SRB model
    (honest encoder emulation — the reference's sensor_update reads real
    encoders, ``BaseInterface.cpp:204-231``):

        q  = IK(foot_body)
        dq = J(q)⁻¹ · d/dt[Rᵀ(p_f − p)] = J⁻¹(Rᵀ(v_f − v) − ω × foot_body)

    with v_f = 0 for stance feet and the FSM swing velocity otherwise.

    dq is clamped to a uniform ±21 rad/s — a conservative bound near the
    Go1 calf actuator limit (go1.urdf: 20.06 rad/s calf, 30.1 hip/thigh),
    deliberately BELOW the 30 rad/s safety kill threshold
    (LeggedSafetyChecker.hpp:16-30): near workspace edges J⁻¹ spikes are a
    pinned-feet model artifact a real encoder could never report, and this
    emulated sensor feeds `safety.is_safe` — an artifact must suppress,
    not kill the scenario. (The COMMANDED swing velocity targets use the
    true per-joint limits — control.torque.JOINT_VEL_LIMIT.)
    """
    from quaternion_mpc_tpu.kin import leg as leg_mod

    rot = lie.quat_to_rotmat(ps.quat)
    q = leg_mod.ik(foot_pos_body, rho_fix)
    v_rel = (foot_vel_world - ps.vel) @ rot - jnp.cross(
        jnp.broadcast_to(ps.omega, foot_pos_body.shape), foot_pos_body
    )
    J = leg_mod.jac(q, rho_fix)
    dq = jnp.linalg.solve(J, v_rel[..., None])[..., 0]
    return q, jnp.clip(dq, -21.0, 21.0)


def _make_grf_update(controller: str, horizon, opts, zero_initial_omega):
    """Controller routing on the config key (Main.cpp:69-91: controller_type
    1 = ConvexMpc, 2 = QuatMpc)."""
    if controller == "quat":
        return quat_mpc.make_controller(horizon, opts, zero_initial_omega)
    if controller == "convex":
        from quaternion_mpc_tpu.control import convex_mpc

        return convex_mpc.make_controller(horizon, opts)
    raise ValueError(f"controller must be 'quat' or 'convex', got {controller!r}")


def _make_fleet_grf(controller: str, horizon, opts, zero_initial_omega,
                    return_sol: bool = False):
    if controller == "quat":
        return quat_mpc.make_fleet_controller(
            horizon, opts, zero_initial_omega=zero_initial_omega,
            return_body=True, return_sol=return_sol,
        )
    if controller == "convex":
        from quaternion_mpc_tpu.control import convex_mpc

        return convex_mpc.make_fleet_controller(
            horizon, opts, return_body=True, return_sol=return_sol
        )
    raise ValueError(f"controller must be 'quat' or 'convex', got {controller!r}")


def make_standing_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=5),
    plant_substeps: int = 2,
    zero_initial_omega: bool = False,
    controller: str = "quat",
):
    """Standing-balance closed loop (SURVEY.md §7 minimum slice): all-stance,
    forces applied directly at the feet; per-scenario safety/divergence
    masking so a failed rollout can't poison the fleet.

    Like `make_walking_step`, the closed loop defaults to the corrected
    controller (ω feedback on, see note there); pass True to reproduce the
    reference's QuatMpc.cpp:242 behavior. ``controller`` picks the MPC
    (quat | convex); pass matching weights in ``ScenarioParams.wts``.
    """
    grf_update = _make_grf_update(controller, horizon, opts, zero_initial_omega)

    def control_step(carry: ScenarioCarry, sp: ScenarioParams,
                     joy: goals.JoyCommand, ext_wrench=None):
        fbk = feedback_from_plant(carry.plant, sp.plant_params.foot_pos_body)
        contacts = jnp.ones_like(fbk.foot_contact)
        goal, cmd = goals.goal_update(carry.goal, fbk, joy, contacts, dt=sp.wts.h)
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(
                sp.target_height - carry.plant.pos[2]
            )
        )

        out, _sol = grf_update(fbk, cmd, sp.wts)

        dt_sub = sp.wts.h / plant_substeps
        new_plant = carry.plant
        for _ in range(plant_substeps):
            new_plant = plant.step(
                new_plant, out.grf_body, sp.plant_params, dt_sub, ext_wrench
            )

        ok = safety.is_safe(new_plant.quat, fbk.joint_vel)
        ok = ok & safety.finite_state(new_plant)
        alive = carry.alive & ok
        # frozen scenarios hold their last healthy state
        kept_plant = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_plant, carry.plant
        )

        height_err = jnp.abs(kept_plant.pos[2] - sp.target_height)
        att_err = 1.0 - jnp.abs(jnp.sum(kept_plant.quat * cmd.quat_d))
        metrics = StepMetrics(
            mpc_cost=out.mpc_cost,
            height_err=height_err,
            att_err=att_err,
            alive=alive.astype(kept_plant.pos.dtype),
        )
        return ScenarioCarry(plant=kept_plant, goal=goal, alive=alive), metrics

    return control_step


class WalkingCarry(NamedTuple):
    plant: plant.PlantState
    goal: goals.GoalState
    gait: "object"            # schedule.GaitState
    feet_world: jnp.ndarray   # (n_feet, 3) simulated foot positions
    alive: jnp.ndarray
    terrain_est: "object" = None  # kin.terrain.TerrainState (pitch adaptation)
    us_prev: "object" = None   # (N, 12) last solution — primal warm start
    lam_prev: "object" = None  # (N+1, nc) last multipliers — dual warm start


class WalkingMetrics(NamedTuple):
    mpc_cost: jnp.ndarray
    vel_err: jnp.ndarray
    height_err: jnp.ndarray
    alive: jnp.ndarray


def make_walking_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=4),
    gait_freq: float = 2.2,
    pattern=None,
    zero_initial_omega: bool = False,
    per_knot_contacts: bool = True,
    controller: str = "quat",
    warm_start: bool = False,
    dual_warm: bool = False,
):
    """Trot-walking closed loop: gait FSM → Raibert footholds → quat-MPC →
    force application at the current stance feet.

    Sim model (SURVEY.md §7.6 intermediate tier): torso SRB + massless feet;
    stance feet are pinned to the ground and realize the commanded GRF
    (ideal low-level force tracking), swing feet follow the quintic FSM
    targets with zero force. Joint angles are recovered via analytic IK each
    tick so the kinematics layer runs in the loop. (For the torque-driven
    joint-level tier, see `make_actuated_walking_step`.)

    Terrain: when ``sp.terrain`` is a `sim.terrain.TerrainParams`, foothold
    targets snap onto the world surface (slope/stairs analogs of
    ``unitree_gazebo/worlds/``), the height target and safety floor are
    ground-relative, and the desired pitch adapts to the fitted walking
    surface (``QuatMpc.cpp:307-335`` via `kin.terrain.terrain_update`).
    """
    from quaternion_mpc_tpu.gait import raibert as raibert_mod
    from quaternion_mpc_tpu.gait import schedule as sched_mod
    from quaternion_mpc_tpu.kin import leg as leg_mod
    from quaternion_mpc_tpu.kin import terrain as kterr_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    if pattern is None:
        pattern = sched_mod.trot_pattern()
    # the closed loop defaults to the CORRECTED controller (ω feedback on):
    # with the reference's ω=0 init quirk (QuatMpc.cpp:242) the idealized
    # force-tracking plant has no other source of attitude damping and the
    # trot tips over after ~2 s; the real reference survives via joint-level
    # impedance the SRB plant doesn't model.
    grf_update = _make_grf_update(controller, horizon, opts, zero_initial_omega)

    def control_step(carry: WalkingCarry, sp: ScenarioParams,
                     joy: goals.JoyCommand, ext_wrench=None):
        ps = carry.plant
        dtype = ps.pos.dtype
        rot = lie.quat_to_rotmat(ps.quat)
        foot_pos_body = (carry.feet_world - ps.pos) @ rot  # Rᵀ(p_f − p) rows
        rho_fix = _sp_rho_fix(sp, dtype)

        contacts_now = sched_mod.contact_flags(carry.gait, pattern).astype(dtype)
        foot_vel_world = jnp.where(
            contacts_now[:, None] > 0.5, 0.0, carry.gait.target_vel
        )
        joint_pos, joint_vel = _pinned_feet_joint_state(
            ps, foot_pos_body, foot_vel_world, rho_fix
        )
        fbk = RobotFeedback(
            torso_pos_world=ps.pos,
            torso_quat=ps.quat,
            torso_lin_vel_world=ps.vel,
            torso_ang_vel_body=ps.omega,
            foot_pos_body=foot_pos_body,
            foot_contact=contacts_now,
            joint_pos=joint_pos.reshape(-1),
            joint_vel=joint_vel.reshape(-1),
        )

        # Raibert foothold targets (BaseInterface.cpp:266-288)
        vel_d_rel = jnp.stack([joy.velx, joy.vely, jnp.zeros_like(joy.velx)])
        default_rel = _sp_default_rel(sp, dtype)
        target_world, _ = raibert_mod.foothold_targets(
            ps.pos, ps.quat, ps.vel, vel_d_rel, default_rel, gait_freq
        )
        # feet land ON the world surface (z=0 for the flat default)
        tp = sp.terrain if sp.terrain is not None else terrain_mod.make_terrain(
            "flat", dtype=dtype
        )
        target_world = terrain_mod.snap_to_ground(tp, target_world)

        gait = sched_mod.gait_update(
            carry.gait,
            pattern,
            sp.wts.h,
            jnp.asarray(gait_freq, dtype),
            carry.feet_world,
            target_world,
            contacts_now > 0.5,
        )
        plan_contacts = sched_mod.contact_flags(gait, pattern).astype(dtype)
        # per-knot (N+1, n_feet) schedule: the MPC sees upcoming stance
        # switches inside its horizon (wires the reference's unplumbed
        # predict_contact_state, LeggedContactFSM.cpp:272-286)
        mpc_contacts = plan_contacts
        if per_knot_contacts:
            mpc_contacts = sched_mod.predict_contact_schedule(
                gait, pattern, jnp.asarray(gait_freq, dtype), sp.wts.h, horizon + 1
            ).astype(dtype)

        goal, cmd = goals.goal_update(carry.goal, fbk, joy, mpc_contacts, dt=sp.wts.h)
        # ground-relative height target: local ground = contact-weighted mean
        # stance-foot height (smooth on stairs; exact on flat/slope)
        n_stance = jnp.maximum(jnp.sum(plan_contacts), 1.0)
        ground_z = jnp.sum(carry.feet_world[:, 2] * plan_contacts) / n_stance
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(
                ground_z + sp.target_height - ps.pos[2]
            )
        )
        # walking-surface pitch adaptation (QuatMpc.cpp:307-335)
        terr_est, pitch_d = kterr_mod.terrain_update(
            carry.terrain_est,
            carry.feet_world - ps.pos,
            movement_mode=1,
            torso_height=ps.pos[2] - ground_z,
            contact_weights=plan_contacts,
        )
        eul_d = lie.quat_to_euler(cmd.quat_d)
        quat_d = lie.euler_to_quat(
            jnp.stack([eul_d[0], eul_d[1] + pitch_d, eul_d[2]])
        )
        cmd = cmd._replace(quat_d=quat_d)
        if warm_start:
            # primal warm start; dual (multiplier) carry is separately
            # opt-in — at higher inner-iteration counts the cross-tick
            # multiplier dynamics can destabilize (measured: 1x2 needs it,
            # 1x3 is better off re-estimating duals each tick)
            out, _sol = grf_update(
                fbk, cmd, sp.wts,
                us_init=carry.us_prev,
                lam_init=carry.lam_prev if dual_warm else None,
            )
        else:
            out, _sol = grf_update(fbk, cmd, sp.wts)

        # apply stance forces at the *current* feet; move swing feet to targets
        f_body = out.grf_body * plan_contacts[:, None]
        pp = sp.plant_params._replace(foot_pos_body=foot_pos_body)
        new_plant = plant.step(ps, f_body, pp, sp.wts.h, ext_wrench)
        feet_world = jnp.where(
            plan_contacts[:, None] > 0.5, carry.feet_world, gait.target_pos
        )

        ok = safety.is_safe(new_plant.quat, fbk.joint_vel)
        ground_under = terrain_mod.height(tp, new_plant.pos[:2])
        ok = ok & safety.finite_state(new_plant) & (
            new_plant.pos[2] - ground_under > 0.05
        )
        alive = carry.alive & ok
        kept_plant = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_plant, ps
        )

        yaw = lie.quat_to_euler(kept_plant.quat)[2]
        vel_rel = lie.rotz(yaw).T @ kept_plant.vel
        metrics = WalkingMetrics(
            mpc_cost=out.mpc_cost,
            vel_err=jnp.abs(vel_rel[0] - joy.velx),
            height_err=jnp.abs(kept_plant.pos[2] - ground_z - sp.target_height),
            alive=alive.astype(dtype),
        )
        return (
            WalkingCarry(
                plant=kept_plant, goal=goal, gait=gait, feet_world=feet_world,
                alive=alive, terrain_est=terr_est,
                us_prev=_sol.us if warm_start else carry.us_prev,
                lam_prev=_sol.lam if dual_warm else carry.lam_prev,
            ),
            metrics,
        )

    return control_step


def init_walking_scenario(
    wts: quat_mpc.QuatMpcWeights,
    height: float = 0.3,
    dtype=jnp.float32,
    terrain=None,
    pattern=None,
    ctrl_wts=None,
    warm_start: bool = False,
    horizon: int = 10,
    rho_fix=None,
    default_rel=None,
):
    """``wts`` (QuatMpcWeights) always defines the PLANT physical truth;
    ``ctrl_wts`` (e.g. ConvexMpcWeights) overrides the controller weights in
    ``ScenarioParams.wts`` when running a non-quat controller.
    ``rho_fix``/``default_rel``: per-robot leg geometry / neutral stance
    (None → Go1), e.g. from `utils.config.config_for_robot` +
    `RobotDescription.rho_fix()`."""
    from quaternion_mpc_tpu.gait import schedule as sched_mod
    from quaternion_mpc_tpu.kin import terrain as kterr_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    ps = plant.init_state(height=height, dtype=dtype)
    if default_rel is None:
        default_rel = jnp.asarray(GO1_DEFAULT_REL, dtype=dtype)
    else:
        default_rel = jnp.asarray(default_rel, dtype=dtype)
    if rho_fix is not None:
        rho_fix = jnp.asarray(rho_fix, dtype=dtype)
    feet_world = default_rel + ps.pos
    if terrain is not None:
        feet_world = terrain_mod.snap_to_ground(terrain, feet_world)
    else:
        feet_world = feet_world.at[:, 2].set(0.0)
    pp = plant.PlantParams(
        mass=wts.mass,
        inertia=wts.inertia,
        com_offset=wts.com_offset,
        com_mass=wts.trunk_mass,
        foot_pos_body=default_rel,
    )
    fbk = feedback_from_plant(ps, default_rel)
    if pattern is None:
        pattern = sched_mod.trot_pattern()
    us_prev = None
    lam_prev = None
    if warm_start:
        # seed with the weight-split hover inputs (the problem's default
        # us_init shape), so tick 0 warm-starts sensibly
        cmd0 = goals.goal_update(
            goals.init_goal_state(fbk), fbk,
            goals.JoyCommand(
                velx=jnp.zeros((), dtype), vely=jnp.zeros((), dtype),
                body_height=jnp.asarray(height, dtype),
                roll_rate=jnp.zeros((), dtype), pitch_rate=jnp.zeros((), dtype),
                yaw_rate=jnp.zeros((), dtype), sin_ang_vel=jnp.asarray(False),
            ),
            jnp.ones((4,), dtype), dt=wts.h,
        )[1]
        prob0 = quat_mpc.build_problem(fbk, cmd0, wts, horizon)
        us_prev = prob0.us_init
        # Seed lam_prev too so the carry pytree structure is stable from
        # tick 0 under make_walking_step(dual_warm=True) — a None→array
        # structure change after the first tick breaks lax.scan drivers.
        lam_prev = jnp.zeros((horizon + 1, prob0.cb.shape[-1]), dtype=dtype)
    carry = WalkingCarry(
        plant=ps,
        goal=goals.init_goal_state(fbk),
        gait=sched_mod.init_gait_state(feet_world, pattern),
        feet_world=feet_world,
        alive=jnp.asarray(True),
        terrain_est=kterr_mod.init_terrain_state(dtype=dtype),
        us_prev=us_prev,
        lam_prev=lam_prev,
    )
    sp = ScenarioParams(
        wts=wts if ctrl_wts is None else ctrl_wts, plant_params=pp,
        target_height=jnp.asarray(height, dtype), terrain=terrain,
        rho_fix=rho_fix, default_rel=default_rel,
    )
    return carry, sp


def init_scenario(
    wts: quat_mpc.QuatMpcWeights,
    foot_pos_body,
    height: float = 0.3,
    dtype=jnp.float32,
    ctrl_wts=None,
):
    ps = plant.init_state(height=height, dtype=dtype)
    pp = plant.PlantParams(
        mass=wts.mass,
        inertia=wts.inertia,
        com_offset=wts.com_offset,
        com_mass=wts.trunk_mass,
        foot_pos_body=jnp.asarray(foot_pos_body, dtype=dtype),
    )
    fbk = feedback_from_plant(ps, pp.foot_pos_body)
    carry = ScenarioCarry(
        plant=ps,
        goal=goals.init_goal_state(fbk),
        alive=jnp.asarray(True),
    )
    sp = ScenarioParams(
        wts=wts if ctrl_wts is None else ctrl_wts,
        plant_params=pp,
        target_height=jnp.asarray(height, dtype),
    )
    return carry, sp


def neutral_joy(dtype=jnp.float32) -> goals.JoyCommand:
    z = jnp.zeros((), dtype=dtype)
    return goals.JoyCommand(
        velx=z, vely=z, body_height=jnp.asarray(0.3, dtype),
        roll_rate=z, pitch_rate=z, yaw_rate=z,
        sin_ang_vel=jnp.asarray(False),
    )


class EstimatedCarry(NamedTuple):
    plant: plant.PlantState
    goal: goals.GoalState
    kf: "object"            # est.kf.KFState
    feet_world: jnp.ndarray  # (n_feet, 3) ground-pinned stance feet
    alive: jnp.ndarray


def make_estimated_standing_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=5),
    plant_substeps: int = 2,
):
    """Standing balance closed over the ESTIMATED state (kf_type=1 path,
    ``BaseInterface.cpp:293-342`` + BasicKF): the controller sees torso
    position/velocity from the contact-aided linear KF driven by synthetic
    IMU (specific force from the commanded GRFs) and leg kinematics, with
    attitude taken from the IMU as in the reference. Ground truth stays in
    the plant only."""
    from quaternion_mpc_tpu.est import kf as kf_mod
    from quaternion_mpc_tpu.ops import lie as lie_mod

    grf_update = quat_mpc.make_controller(horizon, opts)

    def control_step(carry: EstimatedCarry, sp: ScenarioParams,
                     joy: goals.JoyCommand, ext_wrench=None):
        ps = carry.plant
        rot = lie_mod.quat_to_rotmat(ps.quat)
        # feet are pinned to the ground: leg kinematics reflect the TRUE
        # body pose, which is exactly what gives the KF height information
        foot_body = (carry.feet_world - ps.pos) @ rot
        # estimated feedback: KF position/velocity, IMU attitude/rates
        est_pos = carry.kf.x[0:3]
        est_vel = carry.kf.x[3:6]
        fbk = RobotFeedback(
            torso_pos_world=est_pos,
            torso_quat=ps.quat,
            torso_lin_vel_world=est_vel,
            torso_ang_vel_body=ps.omega,
            foot_pos_body=foot_body,
            foot_contact=jnp.ones((foot_body.shape[0],), dtype=ps.pos.dtype),
            joint_pos=jnp.zeros((12,), dtype=ps.pos.dtype),
            joint_vel=jnp.zeros((12,), dtype=ps.pos.dtype),
        )
        contacts = jnp.ones_like(fbk.foot_contact)
        goal, cmd = goals.goal_update(carry.goal, fbk, joy, contacts, dt=sp.wts.h)
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(sp.target_height - est_pos[2])
        )
        out, _sol = grf_update(fbk, cmd, sp.wts)

        dt_sub = sp.wts.h / plant_substeps
        pp = sp.plant_params._replace(foot_pos_body=foot_body)
        new_plant = ps
        for _ in range(plant_substeps):
            new_plant = plant.step(new_plant, out.grf_body, pp, dt_sub, ext_wrench)

        # KF tick: IMU specific force = Σf_body / m (a_w = R·Σf/m + g)
        acc_body = jnp.sum(out.grf_body, axis=0) / sp.plant_params.mass
        rot_new = lie_mod.quat_to_rotmat(new_plant.quat)
        foot_body_new = (carry.feet_world - new_plant.pos) @ rot_new
        # leg odometry: feet fixed in world => J·dq = d/dt(Rᵀ(p_f − p))
        #             = −ω × foot_body − Rᵀ·v
        foot_vel_rel = jnp.broadcast_to(
            -(rot_new.T @ new_plant.vel), foot_body_new.shape
        ) - jnp.cross(
            jnp.broadcast_to(new_plant.omega, foot_body_new.shape), foot_body_new
        )
        kf_in = kf_mod.KFInputs(
            torso_rot_mat=rot_new,
            torso_lin_acc_body=acc_body,
            torso_ang_vel_body=new_plant.omega,
            foot_pos_body=foot_body_new,
            foot_lin_vel_rel=foot_vel_rel,
            contacts=contacts,
        )
        kf_state, _, _ = kf_mod.update(carry.kf, kf_in, sp.wts.h)

        ok = safety.is_safe(new_plant.quat, fbk.joint_vel)
        ok = ok & safety.finite_state(new_plant)
        alive = carry.alive & ok
        kept_plant = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_plant, ps
        )
        metrics = StepMetrics(
            mpc_cost=out.mpc_cost,
            height_err=jnp.abs(kept_plant.pos[2] - sp.target_height),
            att_err=1.0 - jnp.abs(jnp.sum(kept_plant.quat * cmd.quat_d)),
            alive=alive.astype(kept_plant.pos.dtype),
        )
        return (
            EstimatedCarry(
                plant=kept_plant, goal=goal, kf=kf_state,
                feet_world=carry.feet_world, alive=alive,
            ),
            metrics,
        )

    return control_step


def init_estimated_scenario(
    wts: quat_mpc.QuatMpcWeights,
    foot_pos_body,
    height: float = 0.3,
    dtype=jnp.float32,
):
    """Like `init_scenario` but with a BasicKF carry; the KF starts at the
    reference's canonical init (p=(0,0,0.09), BasicKF.cpp:59-71) and must
    converge to the true state during the run."""
    from quaternion_mpc_tpu.est import kf as kf_mod
    from quaternion_mpc_tpu.ops import lie as lie_mod

    base, sp = init_scenario(wts, foot_pos_body, height, dtype)
    rot = lie_mod.quat_to_rotmat(base.plant.quat)
    kf0 = kf_mod.init_state(rot, sp.plant_params.foot_pos_body, dtype=dtype)
    # ground-pinned feet: the KF's foot-height measurement assumes the
    # ground plane is z = 0, so stance feet must start there
    feet_world = base.plant.pos + jnp.asarray(foot_pos_body, dtype)
    feet_world = feet_world.at[:, 2].set(0.0)
    carry = EstimatedCarry(
        plant=base.plant, goal=base.goal, kf=kf0,
        feet_world=feet_world, alive=base.alive,
    )
    return carry, sp


class EstWalkingCarry(NamedTuple):
    plant: plant.PlantState
    goal: goals.GoalState
    gait: "object"
    feet_world: jnp.ndarray
    terrain_est: "object"
    est: "object"             # kf.KFState | ekf.EkfState | None (kf_type 0)
    alive: jnp.ndarray
    tick: "object" = None        # int32 scalar — mocap scheduling
    mocap_count: "object" = None  # int32 scalar — mocap warm-up drop
    key: "object" = None         # per-scenario PRNG key (fleet sensor noise)


def make_estimated_walking_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=4),
    gait_freq: float = 2.2,
    pattern=None,
    kf_type: int = 1,
    per_knot_contacts: bool = True,
    mocap_every: int = 5,
    mocap_warmup: int = 10,
):
    """Trot closed over the ESTIMATED state with the reference's estimator
    routing (``GazeboInterface.cpp:136-192`` / ``HardwareInterface.cpp:183-214``):

    - kf_type=0: ground truth (gt_pose_callback direct write);
    - kf_type=1: BasicKF 18/28 linear KF (contact-aided leg odometry);
    - kf_type=2: 21-state EKF (`est.ekf`, the CasADi-submodule equivalent)
      with simulated-mocap fusion at the mocap callback rate — every
      ``mocap_every``-th tick, after dropping the first ``mocap_warmup``
      samples (``GazeboInterface.cpp:176-192``) — the returned step takes
      an optional 4th argument ``mocap_on`` (scalar bool) to model
      dropout/re-fusion; default on.

    The controller sees estimated torso position/velocity; attitude and
    body rates come from the IMU as in the reference. Ground truth lives
    only in the plant."""
    from quaternion_mpc_tpu.est import ekf as ekf_mod
    from quaternion_mpc_tpu.est import kf as kf_mod
    from quaternion_mpc_tpu.gait import raibert as raibert_mod
    from quaternion_mpc_tpu.gait import schedule as sched_mod
    from quaternion_mpc_tpu.kin import leg as leg_mod
    from quaternion_mpc_tpu.kin import terrain as kterr_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    if pattern is None:
        pattern = sched_mod.trot_pattern()
    if kf_type not in (0, 1, 2):
        raise ValueError(f"kf_type must be 0, 1 or 2, got {kf_type}")
    grf_update = quat_mpc.make_controller(horizon, opts, zero_initial_omega=False)

    def control_step(
        carry: EstWalkingCarry, sp: ScenarioParams, joy: goals.JoyCommand,
        mocap_on=None, ext_wrench=None,
    ):
        ps = carry.plant
        dtype = ps.pos.dtype
        rot = lie.quat_to_rotmat(ps.quat)
        # encoders see the TRUE kinematics (feet pinned in world)
        foot_pos_body = (carry.feet_world - ps.pos) @ rot
        rho_fix = _sp_rho_fix(sp, dtype)

        # estimated torso pos/vel per kf_type; IMU attitude/rates are true
        if kf_type == 0:
            est_pos, est_vel = ps.pos, ps.vel
        elif kf_type == 1:
            est_pos, est_vel = carry.est.x[0:3], carry.est.x[3:6]
        else:
            est_pos, est_vel = carry.est.x[0:3], carry.est.x[3:6]

        contacts_now = sched_mod.contact_flags(carry.gait, pattern).astype(dtype)
        foot_vel_world_now = jnp.where(
            contacts_now[:, None] > 0.5, 0.0, carry.gait.target_vel
        )
        joint_pos, joint_vel = _pinned_feet_joint_state(
            ps, foot_pos_body, foot_vel_world_now, rho_fix
        )
        fbk = RobotFeedback(
            torso_pos_world=est_pos,
            torso_quat=ps.quat,
            torso_lin_vel_world=est_vel,
            torso_ang_vel_body=ps.omega,
            foot_pos_body=foot_pos_body,
            foot_contact=contacts_now,
            joint_pos=joint_pos.reshape(-1),
            joint_vel=joint_vel.reshape(-1),
        )

        vel_d_rel = jnp.stack([joy.velx, joy.vely, jnp.zeros_like(joy.velx)])
        default_rel = _sp_default_rel(sp, dtype)
        # Raibert runs on the ESTIMATED velocity (BaseInterface.cpp:266-288
        # uses fbk.torso_lin_vel_* from the estimator) but true foot anchors
        target_world, _ = raibert_mod.foothold_targets(
            ps.pos, ps.quat, est_vel, vel_d_rel, default_rel, gait_freq
        )
        tp = sp.terrain if sp.terrain is not None else terrain_mod.make_terrain(
            "flat", dtype=dtype
        )
        target_world = terrain_mod.snap_to_ground(tp, target_world)
        gait = sched_mod.gait_update(
            carry.gait, pattern, sp.wts.h, jnp.asarray(gait_freq, dtype),
            carry.feet_world, target_world, contacts_now > 0.5,
        )
        plan_contacts = sched_mod.contact_flags(gait, pattern).astype(dtype)
        mpc_contacts = plan_contacts
        if per_knot_contacts:
            mpc_contacts = sched_mod.predict_contact_schedule(
                gait, pattern, jnp.asarray(gait_freq, dtype), sp.wts.h, horizon + 1
            ).astype(dtype)
        goal, cmd = goals.goal_update(carry.goal, fbk, joy, mpc_contacts, dt=sp.wts.h)
        n_stance = jnp.maximum(jnp.sum(plan_contacts), 1.0)
        ground_z = jnp.sum(carry.feet_world[:, 2] * plan_contacts) / n_stance
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(
                ground_z + sp.target_height - est_pos[2]
            )
        )
        terr_est, pitch_d = kterr_mod.terrain_update(
            carry.terrain_est, carry.feet_world - ps.pos,
            movement_mode=1, torso_height=est_pos[2] - ground_z,
            contact_weights=plan_contacts,
        )
        eul_d = lie.quat_to_euler(cmd.quat_d)
        cmd = cmd._replace(
            quat_d=lie.euler_to_quat(
                jnp.stack([eul_d[0], eul_d[1] + pitch_d, eul_d[2]])
            )
        )
        out, _sol = grf_update(fbk, cmd, sp.wts)

        f_body = out.grf_body * plan_contacts[:, None]
        pp = sp.plant_params._replace(foot_pos_body=foot_pos_body)
        new_plant = plant.step(ps, f_body, pp, sp.wts.h, ext_wrench)
        feet_world = jnp.where(
            plan_contacts[:, None] > 0.5, carry.feet_world, gait.target_pos
        )

        # --- estimator tick against the NEW plant state
        est_state = carry.est
        tick = (jnp.zeros((), jnp.int32) if carry.tick is None else carry.tick)
        mocap_count = (
            jnp.zeros((), jnp.int32) if carry.mocap_count is None
            else carry.mocap_count
        )
        if kf_type > 0:
            rot_new = lie.quat_to_rotmat(new_plant.quat)
            foot_body_new = (feet_world - new_plant.pos) @ rot_new
            # IMU specific force from the realized stance forces
            acc_body = jnp.sum(f_body, axis=0) / sp.plant_params.mass
            # rel foot velocity d/dt Rᵀ(p_f − p): stance feet are fixed,
            # swing feet move at the FSM target velocity
            v_feet = jnp.where(
                plan_contacts[:, None] > 0.5, 0.0, gait.target_vel
            )
            foot_vel_rel = (v_feet - new_plant.vel) @ rot_new - jnp.cross(
                jnp.broadcast_to(new_plant.omega, foot_body_new.shape),
                foot_body_new,
            )
            # terrain-aware height reference under the ESTIMATED foot xy,
            # de-weighted by the local height spread within the estimate's
            # xy uncertainty (riser aliasing — see est_actuated notes)
            feet_xy_est = (
                carry.est.x[0:3] + foot_body_new @ rot_new.T
            )[:, :2]
            href = terrain_mod.height(tp, feet_xy_est)
            _r = jnp.asarray(0.03, dtype)
            _offs = jnp.stack([
                jnp.zeros((2,), dtype),
                jnp.asarray([1.0, 0.0], dtype) * _r,
                jnp.asarray([-1.0, 0.0], dtype) * _r,
                jnp.asarray([0.0, 1.0], dtype) * _r,
                jnp.asarray([0.0, -1.0], dtype) * _r,
            ])
            _hs = terrain_mod.height(
                tp, (feet_xy_est[:, None, :] + _offs[None]).reshape(-1, 2)
            ).reshape(4, 5)
            _spread = jnp.max(_hs, axis=1) - jnp.min(_hs, axis=1)
            h_noise_scale = 1.0 + (_spread / 0.005) ** 2
            if kf_type == 1:
                kf_in = kf_mod.KFInputs(
                    torso_rot_mat=rot_new,
                    torso_lin_acc_body=acc_body,
                    torso_ang_vel_body=new_plant.omega,
                    foot_pos_body=foot_body_new,
                    foot_lin_vel_rel=foot_vel_rel,
                    contacts=plan_contacts,
                )
                est_state, _, _ = kf_mod.update(
                    carry.est, kf_in, sp.wts.h, foot_height_ref=href,
                    foot_height_noise_scale=h_noise_scale,
                )
            else:
                ekf_in = ekf_mod.EkfInputs(
                    torso_lin_acc_body=acc_body,
                    torso_ang_vel_body=new_plant.omega,
                    foot_pos_body=foot_body_new,
                    foot_lin_vel_rel=foot_vel_rel,
                    contacts=plan_contacts,
                )
                est_state, _, _ = ekf_mod.update(
                    carry.est, ekf_in, sp.wts.h, foot_height_ref=href
                )
                # simulated mocap (GazeboInterface kf_type=2 path): true pose
                # + yaw, fused at the mocap callback rate with a warm-up
                # drop (first `mocap_warmup` samples discarded,
                # GazeboInterface.cpp:176-183), gated by mocap_on for
                # dropout tests
                sample_due = (tick % mocap_every) == 0
                if mocap_on is not None:
                    sample_due = sample_due & jnp.asarray(mocap_on)
                mocap_count = mocap_count + sample_due.astype(jnp.int32)
                fuse = sample_due & (mocap_count > mocap_warmup)
                fused = ekf_mod.mocap_update(
                    est_state, new_plant.pos,
                    lie.quat_to_euler(new_plant.quat)[2],
                )
                est_state = jax.tree.map(
                    lambda a, b: jnp.where(fuse, a, b), fused, est_state
                )

        ground_under = terrain_mod.height(tp, new_plant.pos[:2])
        ok = safety.is_safe(new_plant.quat, fbk.joint_vel)
        ok = ok & safety.finite_state(new_plant) & (
            new_plant.pos[2] - ground_under > 0.05
        )
        alive = carry.alive & ok
        kept_plant = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_plant, ps
        )
        yaw = lie.quat_to_euler(kept_plant.quat)[2]
        vel_rel = lie.rotz(yaw).T @ kept_plant.vel
        metrics = WalkingMetrics(
            mpc_cost=out.mpc_cost,
            vel_err=jnp.abs(vel_rel[0] - joy.velx),
            height_err=jnp.abs(kept_plant.pos[2] - ground_z - sp.target_height),
            alive=alive.astype(dtype),
        )
        return (
            EstWalkingCarry(
                plant=kept_plant, goal=goal, gait=gait, feet_world=feet_world,
                terrain_est=terr_est, est=est_state, alive=alive,
                tick=tick + 1, mocap_count=mocap_count,
            ),
            metrics,
        )

    return control_step


def init_estimated_walking_scenario(
    wts: quat_mpc.QuatMpcWeights,
    height: float = 0.3,
    dtype=jnp.float32,
    terrain=None,
    kf_type: int = 1,
    pattern=None,
):
    """Walking carry + per-kf_type estimator state. BasicKF starts at the
    reference's canonical init (BasicKF.cpp:59-71); the EKF starts at the
    true pose (init_filter semantics, BaseInterface.cpp:322-328)."""
    from quaternion_mpc_tpu.est import ekf as ekf_mod
    from quaternion_mpc_tpu.est import kf as kf_mod

    base, sp = init_walking_scenario(wts, height, dtype, terrain, pattern)
    rot = lie.quat_to_rotmat(base.plant.quat)
    foot_body = (base.feet_world - base.plant.pos) @ rot
    if kf_type == 1:
        est = kf_mod.init_state(rot, foot_body, dtype=dtype)
    elif kf_type == 2:
        est = ekf_mod.init_state(
            base.plant.pos, lie.quat_to_euler(base.plant.quat), foot_body
        )
    else:
        est = None
    carry = EstWalkingCarry(
        plant=base.plant, goal=base.goal, gait=base.gait,
        feet_world=base.feet_world, terrain_est=base.terrain_est,
        est=est, alive=base.alive,
        tick=jnp.zeros((), jnp.int32),
        mocap_count=jnp.zeros((), jnp.int32),
    )
    return carry, sp


class EstFleetMetrics(NamedTuple):
    mpc_cost: jnp.ndarray
    vel_err: jnp.ndarray
    height_err: jnp.ndarray
    est_err: jnp.ndarray      # |estimated pos − true pos|
    alive: jnp.ndarray


def make_fleet_estimated_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=4),
    gait_freq: float = 2.2,
    pattern=None,
    kf_type: int = 1,
    per_knot_contacts: bool = True,
    mocap_every: int = 5,
    mocap_warmup: int = 10,
    noise_acc: float = 0.0,
    noise_gyro: float = 0.0,
    noise_foot_vel: float = 0.0,
    noise_foot_pos: float = 0.0,
):
    """Fleet-native ESTIMATED trot: the full GazeboInterface-shaped loop —
    derived-only sensing → KF/EKF → MPC → plant (``GazeboInterface.cpp:58-82``,
    ``BaseInterface.cpp:194-342``) — with the MPC solve routed through the
    batch-last fleet solver and the estimator state living in the
    batch-leading carry. This closes the SURVEY §2.3 data-parallel
    obligation for the pipeline that matters: the scenario fleet is the DP
    axis for full estimator-in-the-loop robots, not just the ground-truth
    SRB tier.

    Carry: `EstWalkingCarry` (+ a per-scenario PRNG key in ``key``) — tile
    `init_estimated_walking_scenario` outputs batch-leading and attach
    ``key=jax.random.split(key0, B)``.

    Per-scenario SENSOR NOISE (zero-mean Gaussian, applied to the
    ESTIMATOR's inputs only — the controller consumes the estimate, so
    noise reaches it the honest way, through the filter): ``noise_acc``
    (m/s², IMU specific force), ``noise_gyro`` (rad/s), ``noise_foot_vel``
    (m/s, leg-odometry velocity), ``noise_foot_pos`` (m, FK position).
    Each scenario draws from its own key stream, so a heterogeneous fleet
    sees independent realizations. With all stds 0 the step is exactly the
    vmapped single-robot `make_estimated_walking_step` modulo solver fp
    ordering (parity-tested on the virtual mesh).

    kf_type: 0 ground truth | 1 BasicKF | 2 EKF + simulated mocap fusion
    at the mocap callback rate (per-scenario tick counters in the carry).
    """
    from quaternion_mpc_tpu.est import ekf as ekf_mod
    from quaternion_mpc_tpu.est import kf as kf_mod
    from quaternion_mpc_tpu.gait import raibert as raibert_mod
    from quaternion_mpc_tpu.gait import schedule as sched_mod
    from quaternion_mpc_tpu.kin import terrain as kterr_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    if pattern is None:
        pattern = sched_mod.trot_pattern()
    if kf_type not in (0, 1, 2):
        raise ValueError(f"kf_type must be 0, 1 or 2, got {kf_type}")
    fleet_grf = _make_fleet_grf("quat", horizon, opts, zero_initial_omega=False)
    any_noise = any(
        s > 0.0 for s in (noise_acc, noise_gyro, noise_foot_vel, noise_foot_pos)
    )

    def pre(carry: EstWalkingCarry, sp: ScenarioParams, joy: goals.JoyCommand):
        ps = carry.plant
        dtype = ps.pos.dtype
        rot = lie.quat_to_rotmat(ps.quat)
        foot_pos_body = (carry.feet_world - ps.pos) @ rot
        rho_fix = _sp_rho_fix(sp, dtype)
        if kf_type == 0:
            est_pos, est_vel = ps.pos, ps.vel
        else:
            est_pos, est_vel = carry.est.x[0:3], carry.est.x[3:6]
        contacts_now = sched_mod.contact_flags(carry.gait, pattern).astype(dtype)
        foot_vel_world_now = jnp.where(
            contacts_now[:, None] > 0.5, 0.0, carry.gait.target_vel
        )
        joint_pos, joint_vel = _pinned_feet_joint_state(
            ps, foot_pos_body, foot_vel_world_now, rho_fix
        )
        fbk = RobotFeedback(
            torso_pos_world=est_pos,
            torso_quat=ps.quat,
            torso_lin_vel_world=est_vel,
            torso_ang_vel_body=ps.omega,
            foot_pos_body=foot_pos_body,
            foot_contact=contacts_now,
            joint_pos=joint_pos.reshape(-1),
            joint_vel=joint_vel.reshape(-1),
        )
        vel_d_rel = jnp.stack([joy.velx, joy.vely, jnp.zeros_like(joy.velx)])
        default_rel = _sp_default_rel(sp, dtype)
        # Raibert on the ESTIMATED velocity, true foot anchors
        target_world, _ = raibert_mod.foothold_targets(
            ps.pos, ps.quat, est_vel, vel_d_rel, default_rel, gait_freq
        )
        tp = sp.terrain if sp.terrain is not None else terrain_mod.make_terrain(
            "flat", dtype=dtype
        )
        target_world = terrain_mod.snap_to_ground(tp, target_world)
        gait = sched_mod.gait_update(
            carry.gait, pattern, sp.wts.h, jnp.asarray(gait_freq, dtype),
            carry.feet_world, target_world, contacts_now > 0.5,
        )
        plan_contacts = sched_mod.contact_flags(gait, pattern).astype(dtype)
        mpc_contacts = plan_contacts
        if per_knot_contacts:
            mpc_contacts = sched_mod.predict_contact_schedule(
                gait, pattern, jnp.asarray(gait_freq, dtype), sp.wts.h,
                horizon + 1,
            ).astype(dtype)
        goal, cmd = goals.goal_update(carry.goal, fbk, joy, mpc_contacts, dt=sp.wts.h)
        n_stance = jnp.maximum(jnp.sum(plan_contacts), 1.0)
        ground_z = jnp.sum(carry.feet_world[:, 2] * plan_contacts) / n_stance
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(
                ground_z + sp.target_height - est_pos[2]
            )
        )
        terr_est, pitch_d = kterr_mod.terrain_update(
            carry.terrain_est, carry.feet_world - ps.pos,
            movement_mode=1, torso_height=est_pos[2] - ground_z,
            contact_weights=plan_contacts,
        )
        eul_d = lie.quat_to_euler(cmd.quat_d)
        cmd = cmd._replace(
            quat_d=lie.euler_to_quat(
                jnp.stack([eul_d[0], eul_d[1] + pitch_d, eul_d[2]])
            )
        )
        return (fbk, cmd, goal, gait, plan_contacts, foot_pos_body, terr_est,
                ground_z)

    def post(carry, sp, joy, goal, gait, plan_contacts, foot_pos_body,
             terr_est, ground_z, grf_body, cost, ext, mocap_on):
        ps = carry.plant
        dtype = ps.pos.dtype
        f_body = grf_body * plan_contacts[:, None]
        pp = sp.plant_params._replace(foot_pos_body=foot_pos_body)
        new_plant = plant.step(ps, f_body, pp, sp.wts.h, ext)
        feet_world = jnp.where(
            plan_contacts[:, None] > 0.5, carry.feet_world, gait.target_pos
        )
        tp = sp.terrain if sp.terrain is not None else terrain_mod.make_terrain(
            "flat", dtype=dtype
        )

        est_state = carry.est
        tick = carry.tick
        mocap_count = carry.mocap_count
        key_new = carry.key
        if kf_type > 0:
            rot_new = lie.quat_to_rotmat(new_plant.quat)
            foot_body_new = (feet_world - new_plant.pos) @ rot_new
            acc_body = jnp.sum(f_body, axis=0) / sp.plant_params.mass
            v_feet = jnp.where(
                plan_contacts[:, None] > 0.5, 0.0, gait.target_vel
            )
            foot_vel_rel = (v_feet - new_plant.vel) @ rot_new - jnp.cross(
                jnp.broadcast_to(new_plant.omega, foot_body_new.shape),
                foot_body_new,
            )
            omega_meas = new_plant.omega
            foot_body_meas = foot_body_new
            if any_noise:
                key_new, ka, kg, kv, kp = jax.random.split(carry.key, 5)
                acc_body = acc_body + noise_acc * jax.random.normal(
                    ka, acc_body.shape, dtype
                )
                omega_meas = omega_meas + noise_gyro * jax.random.normal(
                    kg, omega_meas.shape, dtype
                )
                foot_vel_rel = foot_vel_rel + noise_foot_vel * jax.random.normal(
                    kv, foot_vel_rel.shape, dtype
                )
                foot_body_meas = foot_body_meas + noise_foot_pos * (
                    jax.random.normal(kp, foot_body_new.shape, dtype)
                )
            # terrain-aware height reference under the ESTIMATED foot xy
            feet_xy_est = (
                carry.est.x[0:3] + foot_body_meas @ rot_new.T
            )[:, :2]
            href = terrain_mod.height(tp, feet_xy_est)
            _r = jnp.asarray(0.03, dtype)
            _offs = jnp.stack([
                jnp.zeros((2,), dtype),
                jnp.asarray([1.0, 0.0], dtype) * _r,
                jnp.asarray([-1.0, 0.0], dtype) * _r,
                jnp.asarray([0.0, 1.0], dtype) * _r,
                jnp.asarray([0.0, -1.0], dtype) * _r,
            ])
            _hs = terrain_mod.height(
                tp, (feet_xy_est[:, None, :] + _offs[None]).reshape(-1, 2)
            ).reshape(foot_body_new.shape[0], 5)
            _spread = jnp.max(_hs, axis=1) - jnp.min(_hs, axis=1)
            h_noise_scale = 1.0 + (_spread / 0.005) ** 2
            if kf_type == 1:
                kf_in = kf_mod.KFInputs(
                    torso_rot_mat=rot_new,
                    torso_lin_acc_body=acc_body,
                    torso_ang_vel_body=omega_meas,
                    foot_pos_body=foot_body_meas,
                    foot_lin_vel_rel=foot_vel_rel,
                    contacts=plan_contacts,
                )
                est_state, _, _ = kf_mod.update(
                    carry.est, kf_in, sp.wts.h, foot_height_ref=href,
                    foot_height_noise_scale=h_noise_scale,
                )
            else:
                ekf_in = ekf_mod.EkfInputs(
                    torso_lin_acc_body=acc_body,
                    torso_ang_vel_body=omega_meas,
                    foot_pos_body=foot_body_meas,
                    foot_lin_vel_rel=foot_vel_rel,
                    contacts=plan_contacts,
                )
                est_state, _, _ = ekf_mod.update(
                    carry.est, ekf_in, sp.wts.h, foot_height_ref=href
                )
                sample_due = (tick % mocap_every) == 0
                if mocap_on is not None:
                    sample_due = sample_due & jnp.asarray(mocap_on)
                mocap_count = mocap_count + sample_due.astype(jnp.int32)
                fuse = sample_due & (mocap_count > mocap_warmup)
                fused = ekf_mod.mocap_update(
                    est_state, new_plant.pos,
                    lie.quat_to_euler(new_plant.quat)[2],
                )
                est_state = jax.tree.map(
                    lambda a, b: jnp.where(fuse, a, b), fused, est_state
                )

        ground_under = terrain_mod.height(tp, new_plant.pos[:2])
        ok = safety.is_safe(new_plant.quat, jnp.zeros((12,), dtype))
        ok = ok & safety.finite_state(new_plant) & (
            new_plant.pos[2] - ground_under > 0.05
        )
        alive = carry.alive & ok
        kept_plant = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_plant, ps
        )
        yaw = lie.quat_to_euler(kept_plant.quat)[2]
        vel_rel = lie.rotz(yaw).T @ kept_plant.vel
        if kf_type > 0:
            est_err = jnp.linalg.norm(est_state.x[0:3] - kept_plant.pos)
        else:
            est_err = jnp.zeros((), dtype)
        metrics = EstFleetMetrics(
            mpc_cost=cost,
            vel_err=jnp.abs(vel_rel[0] - joy.velx),
            height_err=jnp.abs(kept_plant.pos[2] - ground_z - sp.target_height),
            est_err=est_err,
            alive=alive.astype(dtype),
        )
        return (
            EstWalkingCarry(
                plant=kept_plant, goal=goal, gait=gait, feet_world=feet_world,
                terrain_est=terr_est, est=est_state, alive=alive,
                tick=tick + 1, mocap_count=mocap_count, key=key_new,
            ),
            metrics,
        )

    def fleet_step(carry, sp, joy, mocap_on=None, ext_wrench=None):
        (fbk, cmd, goal, gait, plan_contacts, foot_pos_body, terr_est,
         ground_z) = jax.vmap(pre)(carry, sp, joy)
        _, grf_body, cost = fleet_grf(fbk, cmd, sp.wts)
        return jax.vmap(
            post, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None)
        )(
            carry, sp, joy, goal, gait, plan_contacts, foot_pos_body, terr_est,
            ground_z, grf_body, cost, ext_wrench, mocap_on
        )

    return fleet_step


class ActuatedCarry(NamedTuple):
    robot: "object"           # sim.articulated.ArticulatedState
    goal: goals.GoalState
    gait: "object"            # schedule.GaitState
    terrain_est: "object"     # kin.terrain.TerrainState
    alive: jnp.ndarray


class ActuatedScenario(NamedTuple):
    wts: quat_mpc.QuatMpcWeights
    plant: "object"           # sim.articulated.ArticulatedParams
    target_height: jnp.ndarray
    rho_fix: "object" = None      # (4, 5) leg geometry (None -> Go1)
    default_rel: "object" = None  # (4, 3) neutral stance feet (None -> Go1)


def make_actuated_walking_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=4),
    gait_freq: float = 2.2,
    pattern=None,
    n_sub: int = 80,
    per_knot_contacts: bool = True,
    stance_kp_frac: float = 0.0,
):
    """Trot closed over the JOINT-LEVEL plant: the MPC's GRFs reach the
    robot only through the torque layer — swing legs track IK/J⁻¹ targets
    under PD, stance legs apply τ = −Jᵀf (``control/torque.py``, reference
    ``BaseInterface.cpp:344-408``) — and ground forces emerge from the
    terrain contact model (`sim.articulated`), not ideal force tracking.
    Joint positions/velocities are real feedback; foot contact is the
    sigmoid force detector (``BaseInterface.cpp:234-249``), which also
    drives the gait FSM's early-contact transitions.

    n_sub: physics substeps per MPC tick (80 × 0.125 ms at h=10 ms; the
    0.125 ms substep is required for contact-integration stability — see
    sim.articulated.step)."""
    from quaternion_mpc_tpu.control import torque as torque_mod
    from quaternion_mpc_tpu.gait import raibert as raibert_mod
    from quaternion_mpc_tpu.gait import schedule as sched_mod
    from quaternion_mpc_tpu.kin import terrain as kterr_mod
    from quaternion_mpc_tpu.sim import articulated as art_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    if pattern is None:
        pattern = sched_mod.trot_pattern()
    grf_update = quat_mpc.make_controller(horizon, opts, zero_initial_omega=False)

    def control_step(carry: ActuatedCarry, sp: ActuatedScenario,
                     joy: goals.JoyCommand, ext_wrench=None):
        rs = carry.robot
        ap = sp.plant
        ps = rs.torso
        dtype = ps.pos.dtype
        tp = ap.terrain

        foot_body, foot_world, foot_vel_world, J = art_mod.foot_kinematics(rs, ap)
        f_world, _ = art_mod.contact_forces(
            foot_world, foot_vel_world, ap, rs.anchor
        )
        n_vec = terrain_mod.normal(tp, foot_world[..., :2])
        f_normal = jnp.sum(f_world * n_vec, axis=-1)
        contact_prob = terrain_mod.contact_probability(tp, foot_world, f_normal)

        fbk = RobotFeedback(
            torso_pos_world=ps.pos,
            torso_quat=ps.quat,
            torso_lin_vel_world=ps.vel,
            torso_ang_vel_body=ps.omega,
            foot_pos_body=foot_body,
            foot_contact=contact_prob,
            joint_pos=rs.q.reshape(-1),
            joint_vel=rs.dq.reshape(-1),
        )

        vel_d_rel = jnp.stack([joy.velx, joy.vely, jnp.zeros_like(joy.velx)])
        default_rel = _sp_default_rel(sp, dtype)
        target_world, _ = raibert_mod.foothold_targets(
            ps.pos, ps.quat, ps.vel, vel_d_rel, default_rel, gait_freq
        )
        target_world = terrain_mod.snap_to_ground(tp, target_world)

        gait = sched_mod.gait_update(
            carry.gait, pattern, sp.wts.h, jnp.asarray(gait_freq, dtype),
            foot_world, target_world, contact_prob > 0.5,
        )
        plan_contacts = sched_mod.contact_flags(gait, pattern).astype(dtype)
        mpc_contacts = plan_contacts
        if per_knot_contacts:
            mpc_contacts = sched_mod.predict_contact_schedule(
                gait, pattern, jnp.asarray(gait_freq, dtype), sp.wts.h, horizon + 1
            ).astype(dtype)

        goal, cmd = goals.goal_update(carry.goal, fbk, joy, mpc_contacts, dt=sp.wts.h)
        n_stance = jnp.maximum(jnp.sum(plan_contacts), 1.0)
        ground_z = jnp.sum(foot_world[:, 2] * plan_contacts) / n_stance
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(
                ground_z + sp.target_height - ps.pos[2]
            )
        )
        terr_est, pitch_d = kterr_mod.terrain_update(
            carry.terrain_est,
            foot_world - ps.pos,
            movement_mode=1,
            torso_height=ps.pos[2] - ground_z,
            contact_weights=plan_contacts,
        )
        eul_d = lie.quat_to_euler(cmd.quat_d)
        cmd = cmd._replace(
            quat_d=lie.euler_to_quat(
                jnp.stack([eul_d[0], eul_d[1] + pitch_d, eul_d[2]])
            )
        )

        out, _sol = grf_update(fbk, cmd, sp.wts)
        # feed the FSM's swing targets into the low-level layer
        out = out._replace(
            grf_body=out.grf_body * plan_contacts[:, None],
            foot_pos_target_world=gait.target_pos,
            foot_vel_target_world=gait.target_vel,
        )
        targets = torque_mod.tau_ctrl_update(fbk, out, ap.rho_fix, plan_contacts)

        # stance legs: pure torque + joint damping (position PD off, the
        # Unitree stance convention); swing legs: full PD tracking
        # stance anchoring: walk convention is pure torque + damping
        # (kp=0, tau_ctrl_update anchors q_cmd at measured q); a nonzero
        # stance_kp_frac restores a fraction of the position anchor — on
        # stairs a lightly-loaded just-landed foot otherwise slides
        # forward under the horizontal GRF component until it jams into
        # the riser base (measured: 4 cm slide -> corner ring -> kill)
        kp_leg = ap.kp_joint * (
            (1.0 - plan_contacts) + stance_kp_frac * plan_contacts
        )[:, None]
        ap_tick = ap._replace(kp_joint=kp_leg)
        new_robot = art_mod.step(rs, targets, ap_tick, sp.wts.h, n_sub, ext_wrench)

        ground_under = terrain_mod.height(tp, new_robot.torso.pos[:2])
        # collapse check against the SUPPORT height: while the legs straddle
        # a stair riser the terrain point under the torso center jumps a
        # full rise, but the robot stands on its stance feet — min() keeps
        # the mid-straddle climb legal without weakening true-collapse
        # detection (torso sinking toward its stance feet still trips)
        support_z = jnp.minimum(ground_under, ground_z)
        # sustained dq check: rs.dq is the PREVIOUS tick's endpoint
        ok = safety.is_safe_sustained(
            new_robot.torso.quat, new_robot.dq.reshape(-1), rs.dq.reshape(-1)
        )
        ok = ok & safety.finite_state(new_robot.torso) & (
            new_robot.torso.pos[2] - support_z > 0.05
        )
        alive = carry.alive & ok
        kept_robot = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_robot, rs
        )

        yaw = lie.quat_to_euler(kept_robot.torso.quat)[2]
        vel_rel = lie.rotz(yaw).T @ kept_robot.torso.vel
        metrics = WalkingMetrics(
            mpc_cost=out.mpc_cost,
            vel_err=jnp.abs(vel_rel[0] - joy.velx),
            height_err=jnp.abs(
                kept_robot.torso.pos[2] - ground_z - sp.target_height
            ),
            alive=alive.astype(dtype),
        )
        return (
            ActuatedCarry(
                robot=kept_robot, goal=goal, gait=gait,
                terrain_est=terr_est, alive=alive,
            ),
            metrics,
        )

    return control_step


def init_actuated_scenario(
    wts: quat_mpc.QuatMpcWeights,
    height: float = 0.3,
    dtype=jnp.float32,
    terrain=None,
    pattern=None,
    start_x: float = 0.0,
):
    from quaternion_mpc_tpu.gait import schedule as sched_mod
    from quaternion_mpc_tpu.kin import terrain as kterr_mod
    from quaternion_mpc_tpu.sim import articulated as art_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    if terrain is None:
        terrain = terrain_mod.make_terrain("flat", dtype=dtype)
    ap = art_mod.default_params(
        wts.mass, wts.inertia, wts.com_offset, wts.trunk_mass, terrain, dtype
    )
    rs = art_mod.init_state(height=height, rho_fix=ap.rho_fix, dtype=dtype)
    rs = rs._replace(
        torso=rs.torso._replace(pos=rs.torso.pos.at[0].set(start_x))
    )
    foot_body, foot_world, _, _ = art_mod.foot_kinematics(rs, ap)
    fbk = feedback_from_plant(rs.torso, foot_body)
    if pattern is None:
        pattern = sched_mod.trot_pattern()
    carry = ActuatedCarry(
        robot=rs,
        goal=goals.init_goal_state(fbk),
        gait=sched_mod.init_gait_state(foot_world, pattern),
        terrain_est=kterr_mod.init_terrain_state(dtype=dtype),
        alive=jnp.asarray(True),
    )
    sp = ActuatedScenario(
        wts=wts, plant=ap, target_height=jnp.asarray(height, dtype)
    )
    return carry, sp


def make_fleet_standing_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=5),
    plant_substeps: int = 2,
    zero_initial_omega: bool = False,
    controller: str = "quat",
):
    """Fleet-native standing step: batch-LEADING (carry, sp, joy) pytrees,
    but the MPC solve runs through the batch-last fleet solver instead of
    vmapping the per-scenario solver. The
    goal/plant/safety stages stay vmapped per-scenario functions, so the
    behavior matches `vmap(make_standing_step(...))` exactly up to solver
    fp ordering (same corrected zero_initial_omega=False default)."""
    fleet_grf = _make_fleet_grf(controller, horizon, opts, zero_initial_omega)

    def pre(carry: ScenarioCarry, sp: ScenarioParams, joy: goals.JoyCommand):
        fbk = feedback_from_plant(carry.plant, sp.plant_params.foot_pos_body)
        contacts = jnp.ones_like(fbk.foot_contact)
        goal, cmd = goals.goal_update(carry.goal, fbk, joy, contacts, dt=sp.wts.h)
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(sp.target_height - carry.plant.pos[2])
        )
        return fbk, cmd, goal

    def post(carry: ScenarioCarry, sp: ScenarioParams, goal, quat_d, grf_body,
             cost, ext):
        dt_sub = sp.wts.h / plant_substeps
        new_plant = carry.plant
        for _ in range(plant_substeps):
            new_plant = plant.step(new_plant, grf_body, sp.plant_params,
                                   dt_sub, ext)
        ok = safety.is_safe(new_plant.quat, jnp.zeros((12,), new_plant.pos.dtype))
        ok = ok & safety.finite_state(new_plant)
        alive = carry.alive & ok
        kept_plant = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_plant, carry.plant
        )
        metrics = StepMetrics(
            mpc_cost=cost,
            height_err=jnp.abs(kept_plant.pos[2] - sp.target_height),
            att_err=1.0 - jnp.abs(jnp.sum(kept_plant.quat * quat_d)),
            alive=alive.astype(kept_plant.pos.dtype),
        )
        return ScenarioCarry(plant=kept_plant, goal=goal, alive=alive), metrics

    def fleet_step(carry, sp, joy, ext_wrench=None):
        fbk, cmd, goal = jax.vmap(pre)(carry, sp, joy)
        _, grf_body, cost = fleet_grf(fbk, cmd, sp.wts)
        return jax.vmap(post)(
            carry, sp, goal, cmd.quat_d, grf_body, cost, ext_wrench
        )

    return fleet_step


def make_fleet_walking_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=4),
    gait_freq: float = 2.2,
    pattern=None,
    per_knot_contacts: bool = True,
    controller: str = "quat",
    warm_start: bool = False,
    dual_warm: bool = False,
):
    """Fleet-native trot step: gait/kinematics/Raibert stages vmapped, the
    MPC solve through the batch-last fleet solver (see
    `make_fleet_standing_step`). Batch-leading (carry, sp, joy) pytrees.

    ``warm_start``/``dual_warm``: cross-tick primal/dual warm starting
    through the fleet solver (QuatMpc.cpp:250-253 semantics), consuming and
    refreshing ``carry.us_prev``/``carry.lam_prev``. Whatever the flags,
    ``us_prev``/``lam_prev`` are passed through ``post`` unchanged when not
    consumed, so a carry built with ``init_walking_scenario(warm_start=True)``
    keeps a stable pytree structure across ticks (required by lax.scan
    drivers and jit caching)."""
    from quaternion_mpc_tpu.gait import raibert as raibert_mod
    from quaternion_mpc_tpu.gait import schedule as sched_mod
    from quaternion_mpc_tpu.kin import leg as leg_mod
    from quaternion_mpc_tpu.kin import terrain as kterr_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    if pattern is None:
        pattern = sched_mod.trot_pattern()
    fleet_grf = _make_fleet_grf(controller, horizon, opts,
                                zero_initial_omega=False,
                                return_sol=warm_start)

    def pre(carry: WalkingCarry, sp: ScenarioParams, joy: goals.JoyCommand):
        ps = carry.plant
        dtype = ps.pos.dtype
        rot = lie.quat_to_rotmat(ps.quat)
        foot_pos_body = (carry.feet_world - ps.pos) @ rot
        rho_fix = _sp_rho_fix(sp, dtype)
        contacts_now = sched_mod.contact_flags(carry.gait, pattern).astype(dtype)
        foot_vel_world_now = jnp.where(
            contacts_now[:, None] > 0.5, 0.0, carry.gait.target_vel
        )
        joint_pos, joint_vel = _pinned_feet_joint_state(
            ps, foot_pos_body, foot_vel_world_now, rho_fix
        )
        fbk = RobotFeedback(
            torso_pos_world=ps.pos,
            torso_quat=ps.quat,
            torso_lin_vel_world=ps.vel,
            torso_ang_vel_body=ps.omega,
            foot_pos_body=foot_pos_body,
            foot_contact=contacts_now,
            joint_pos=joint_pos.reshape(-1),
            joint_vel=joint_vel.reshape(-1),
        )
        vel_d_rel = jnp.stack([joy.velx, joy.vely, jnp.zeros_like(joy.velx)])
        default_rel = _sp_default_rel(sp, dtype)
        target_world, _ = raibert_mod.foothold_targets(
            ps.pos, ps.quat, ps.vel, vel_d_rel, default_rel, gait_freq
        )
        tp = sp.terrain if sp.terrain is not None else terrain_mod.make_terrain(
            "flat", dtype=dtype
        )
        target_world = terrain_mod.snap_to_ground(tp, target_world)
        gait = sched_mod.gait_update(
            carry.gait, pattern, sp.wts.h, jnp.asarray(gait_freq, dtype),
            carry.feet_world, target_world, contacts_now > 0.5,
        )
        plan_contacts = sched_mod.contact_flags(gait, pattern).astype(dtype)
        mpc_contacts = plan_contacts
        if per_knot_contacts:
            mpc_contacts = sched_mod.predict_contact_schedule(
                gait, pattern, jnp.asarray(gait_freq, dtype), sp.wts.h, horizon + 1
            ).astype(dtype)
        goal, cmd = goals.goal_update(carry.goal, fbk, joy, mpc_contacts, dt=sp.wts.h)
        n_stance = jnp.maximum(jnp.sum(plan_contacts), 1.0)
        ground_z = jnp.sum(carry.feet_world[:, 2] * plan_contacts) / n_stance
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(
                ground_z + sp.target_height - ps.pos[2]
            )
        )
        terr_est, pitch_d = kterr_mod.terrain_update(
            carry.terrain_est,
            carry.feet_world - ps.pos,
            movement_mode=1,
            torso_height=ps.pos[2] - ground_z,
            contact_weights=plan_contacts,
        )
        eul_d = lie.quat_to_euler(cmd.quat_d)
        cmd = cmd._replace(
            quat_d=lie.euler_to_quat(
                jnp.stack([eul_d[0], eul_d[1] + pitch_d, eul_d[2]])
            )
        )
        return fbk, cmd, goal, gait, plan_contacts, foot_pos_body, terr_est, ground_z

    def post(carry, sp, joy, goal, gait, plan_contacts, foot_pos_body, terr_est,
             ground_z, grf_body, cost, ext, us_prev, lam_prev):
        ps = carry.plant
        dtype = ps.pos.dtype
        f_body = grf_body * plan_contacts[:, None]
        pp = sp.plant_params._replace(foot_pos_body=foot_pos_body)
        new_plant = plant.step(ps, f_body, pp, sp.wts.h, ext)
        feet_world = jnp.where(
            plan_contacts[:, None] > 0.5, carry.feet_world, gait.target_pos
        )
        tp = sp.terrain if sp.terrain is not None else terrain_mod.make_terrain(
            "flat", dtype=dtype
        )
        ground_under = terrain_mod.height(tp, new_plant.pos[:2])
        ok = safety.is_safe(new_plant.quat, jnp.zeros((12,), dtype))
        ok = ok & safety.finite_state(new_plant) & (
            new_plant.pos[2] - ground_under > 0.05
        )
        alive = carry.alive & ok
        kept_plant = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_plant, ps
        )
        yaw = lie.quat_to_euler(kept_plant.quat)[2]
        vel_rel = lie.rotz(yaw).T @ kept_plant.vel
        metrics = WalkingMetrics(
            mpc_cost=cost,
            vel_err=jnp.abs(vel_rel[0] - joy.velx),
            height_err=jnp.abs(kept_plant.pos[2] - ground_z - sp.target_height),
            alive=alive.astype(dtype),
        )
        return (
            WalkingCarry(plant=kept_plant, goal=goal, gait=gait,
                         feet_world=feet_world, alive=alive, terrain_est=terr_est,
                         us_prev=us_prev, lam_prev=lam_prev),
            metrics,
        )

    def fleet_step(carry, sp, joy, ext_wrench=None):
        (fbk, cmd, goal, gait, plan_contacts, foot_pos_body, terr_est,
         ground_z) = jax.vmap(pre)(carry, sp, joy)
        if warm_start:
            # carry.lam_prev is stored in the single-path layout (B, N+1, nc)
            # incl. the terminal row; the fleet solver's multipliers cover
            # the N input knots, so slice/zero-pad at this boundary.
            lam_in = carry.lam_prev[:, :-1] if dual_warm else None
            _, grf_body, cost, sol = fleet_grf(
                fbk, cmd, sp.wts, us_init=carry.us_prev, lam_init=lam_in
            )
            us_prev = jnp.moveaxis(sol.us, -1, 0)  # (B, N, nu)
            if dual_warm:
                lam_bf = jnp.moveaxis(sol.lam, -1, 0)  # (B, N, nc)
                lam_prev = carry.lam_prev.at[:, :-1].set(lam_bf)
            else:
                lam_prev = carry.lam_prev
        else:
            _, grf_body, cost = fleet_grf(fbk, cmd, sp.wts)
            us_prev = carry.us_prev
            lam_prev = carry.lam_prev
        return jax.vmap(post)(
            carry, sp, joy, goal, gait, plan_contacts, foot_pos_body, terr_est,
            ground_z, grf_body, cost, ext_wrench, us_prev, lam_prev
        )

    return fleet_step


# ---------------------------------------------------------------------------
# Estimated + actuated walking: the full Gazebo-parity loop in one step
# ---------------------------------------------------------------------------


class EstActuatedCarry(NamedTuple):
    robot: "object"            # sim.articulated.ArticulatedState
    goal: goals.GoalState
    gait: "object"             # schedule.GaitState
    terrain_est: "object"      # kin.terrain.TerrainState
    est: "object"              # kf.KFState | ekf.EkfState | None (kf_type 0)
    prev_targets: "object"     # control.torque.JointTargets commanded last tick
    prev_kp: jnp.ndarray       # (4, 3) joint kp commanded last tick
    prev_vel: jnp.ndarray      # (3,) torso vel one tick ago (IMU differencing)
    tick: jnp.ndarray          # int32 tick counter (mocap scheduling)
    mocap_count: jnp.ndarray   # int32 mocap samples seen (first-N warm-up drop)
    alive: jnp.ndarray


class EstActuatedMetrics(NamedTuple):
    mpc_cost: jnp.ndarray
    vel_err: jnp.ndarray
    height_err: jnp.ndarray
    est_err: jnp.ndarray       # |est pos − true pos|
    alive: jnp.ndarray


def make_estimated_actuated_step(
    horizon: int = 10,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=4),
    gait_freq: float = 2.2,
    pattern=None,
    kf_type: int = 1,
    n_sub: int = 80,
    per_knot_contacts: bool = True,
    mocap_every: int = 5,
    mocap_warmup: int = 10,
    contact_threshold: float = 10.0,
    stance_kp_frac: float = 0.0,
    pitch_preview: float = 0.0,
    crouch: float = 0.0,
    com_shift: float = 0.0,
    edge_forward: bool = False,
    rear_stride_bias: float = 0.0,
):
    """Estimator + torque layer + gait + terrain in ONE closed loop — the
    composition Gazebo mode actually runs (``GazeboInterface.cpp:58-82``
    fbk → est → ctrl → send cycle): the controller NEVER sees ground truth.

    Full-height stair levers (r5, the PARITY.md "next lever" — the 0.17 m
    kinematic wall is a POSTURE problem, not a contact problem):

    - ``pitch_preview`` ∈ [0,1]: blends the reactive plane-fit pitch toward
      the pitch implied by the UPCOMING foothold targets (front-minus-rear
      target height over their separation). The reactive fit lags a full
      stride; on a 0.17 m riser the front hip must already be raised when
      the front leg swings, or the target sits at/above the hip plane and
      IK clamps at the workspace edge.

    - ``crouch`` (m): lowers the commanded torso height by up to this much,
      scaled by the stance-foot height SPREAD (the straddle detector:
      spread ≈ one rise while legs bridge two treads, ~0 on a single
      tread). The rear legs are the height ceiling in a straddle — at full
      extension they cap the torso exactly when the front legs need hip
      height; giving up centimeters of height returns workspace to BOTH
      (front targets drop below the raised-hip plane, rear legs unfold).

    - ``com_shift`` ∈ [0,1]: quasi-static CoM scheduling for the crawl —
      shifts the lateral body-position target toward the centroid of the
      UPCOMING support polygon (read from the predicted contact schedule a
      few knots ahead, so the shift happens BEFORE liftoff). The measured
      0.17 m failure is a roll-over in the first swing after a front foot
      lands on the high tread: support is one high front + two low rears,
      and with the CoM still centered the body rolls toward the lifting
      leg faster than the MPC's force plan can catch.

    Sensing (all derived, nothing oracular):
    - encoders: joint q/dq from the articulated plant;
    - IMU: true attitude/rates (the reference trusts the IMU orientation,
      BasicKF.cpp "orientation assumed known"), specific force from torso
      velocity differencing;
    - foot force via f = J⁻ᵀτ from the COMMANDED servo torque re-evaluated
      at the measured joint state (``BaseInterface.cpp:253-261``) —
      feeding the sigmoid contact detector (:234-249), which gates both
      the estimator and the gait FSM's early-contact path;
    - torso pos/vel from the kf_type-routed estimator: 0 = ground truth
      passthrough, 1 = BasicKF, 2 = EKF + simulated mocap fused every
      ``mocap_every``-th tick after a ``mocap_warmup``-sample drop
      (``GazeboInterface.cpp:176-192``); the returned step takes an
      optional 4th argument ``mocap_on`` for dropout tests.

    Acting: goal → Raibert (on ESTIMATED velocity) → gait FSM → quat-MPC →
    swing IK/J⁻¹ + stance τ = −Jᵀf → explicit PD+τff at the physics rate.
    Ground truth exists only inside the plant and the metrics."""
    from quaternion_mpc_tpu.control import torque as torque_mod
    from quaternion_mpc_tpu.est import ekf as ekf_mod
    from quaternion_mpc_tpu.est import kf as kf_mod
    from quaternion_mpc_tpu.gait import raibert as raibert_mod
    from quaternion_mpc_tpu.gait import schedule as sched_mod
    from quaternion_mpc_tpu.kin import leg as leg_mod
    from quaternion_mpc_tpu.kin import terrain as kterr_mod
    from quaternion_mpc_tpu.sim import articulated as art_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    if pattern is None:
        pattern = sched_mod.trot_pattern()
    if kf_type not in (0, 1, 2):
        raise ValueError(f"kf_type must be 0, 1 or 2, got {kf_type}")
    grf_update = quat_mpc.make_controller(horizon, opts, zero_initial_omega=False)

    def control_step(carry: EstActuatedCarry, sp: ActuatedScenario,
                     joy: goals.JoyCommand, mocap_on=None, ext_wrench=None):
        rs = carry.robot
        ap = sp.plant
        ps = rs.torso
        dtype = ps.pos.dtype
        tp = ap.terrain

        # ---- sensors (no oracle quantities)
        quat = ps.quat                      # IMU attitude
        gyro = ps.omega                     # IMU rates
        rot = lie.quat_to_rotmat(quat)
        accel_body = rot.T @ (
            (ps.vel - carry.prev_vel) / sp.wts.h
            + jnp.array([0.0, 0.0, plant.GRAVITY], dtype=dtype)
        )
        q, dq = rs.q, rs.dq
        foot_body = leg_mod.fk(q, ap.rho_fix)
        J = leg_mod.jac(q, ap.rho_fix)
        foot_vel_rel = jnp.einsum("lij,lj->li", J, dq)

        # commanded servo torque at the measured joint state -> f = J^-T tau
        tau_applied = jnp.clip(
            torque_mod.pd_torque(carry.prev_targets, q, dq,
                                 carry.prev_kp, ap.kd_joint),
            -ap.tau_max, ap.tau_max,
        )
        f_est_body = leg_mod.foot_force_from_torques(q, -tau_applied, ap.rho_fix)
        f_est_up = jnp.einsum("ij,lj->li", rot, f_est_body)[:, 2]
        contact_prob = 1.0 / (
            1.0 + jnp.exp(-10.0 * (f_est_up - contact_threshold))
        )

        # ---- estimator routing (kf_type, GazeboInterface.cpp:136-192)
        # terrain-aware foot-height reference (the WithFootTerrain variant):
        # expected ground height under the ESTIMATED foot xy
        est_pos_prior = ps.pos if kf_type == 0 else (
            carry.est.x[0:3]
        )
        feet_xy_est = (est_pos_prior + foot_body @ rot.T)[:, :2]
        href = terrain_mod.height(tp, feet_xy_est)
        # riser-proximity de-weighting: the local terrain-height SPREAD
        # within the xy estimate uncertainty (±3 cm) is the true variance
        # of the height reference — near a stair riser a ±1 cm horizontal
        # error aliases a full 0.17 m rise (the second-riser fall this
        # closes; reference analog: the WithFootTerrain EKF variant)
        _r = jnp.asarray(0.03, dtype)
        _offs = jnp.stack([
            jnp.zeros((2,), dtype),
            jnp.asarray([1.0, 0.0], dtype) * _r,
            jnp.asarray([-1.0, 0.0], dtype) * _r,
            jnp.asarray([0.0, 1.0], dtype) * _r,
            jnp.asarray([0.0, -1.0], dtype) * _r,
        ])
        _hs = terrain_mod.height(
            tp, (feet_xy_est[:, None, :] + _offs[None]).reshape(-1, 2)
        ).reshape(4, 5)
        _spread = jnp.max(_hs, axis=1) - jnp.min(_hs, axis=1)
        h_noise_scale = 1.0 + (_spread / 0.005) ** 2
        est_state = carry.est
        mocap_count = carry.mocap_count
        if kf_type == 0:
            est_pos, est_vel = ps.pos, ps.vel
        elif kf_type == 1:
            kf_in = kf_mod.KFInputs(
                torso_rot_mat=rot,
                torso_lin_acc_body=accel_body,
                torso_ang_vel_body=gyro,
                foot_pos_body=foot_body,
                foot_lin_vel_rel=foot_vel_rel,
                contacts=contact_prob,
            )
            est_state, est_pos, est_vel = kf_mod.update(
                carry.est, kf_in, sp.wts.h, foot_height_ref=href,
                foot_height_noise_scale=h_noise_scale,
            )
        else:
            ekf_in = ekf_mod.EkfInputs(
                torso_lin_acc_body=accel_body,
                torso_ang_vel_body=gyro,
                foot_pos_body=foot_body,
                foot_lin_vel_rel=foot_vel_rel,
                contacts=contact_prob,
            )
            est_state, est_pos, est_vel = ekf_mod.update(
                carry.est, ekf_in, sp.wts.h, foot_height_ref=href
            )
            # mocap at its own (slower) rate with a warm-up drop
            sample_due = (carry.tick % mocap_every) == 0
            if mocap_on is not None:
                sample_due = sample_due & jnp.asarray(mocap_on)
            mocap_count = mocap_count + sample_due.astype(jnp.int32)
            fuse = sample_due & (mocap_count > mocap_warmup)
            fused = ekf_mod.mocap_update(
                est_state, ps.pos, lie.quat_to_euler(ps.quat)[2]
            )
            est_state = jax.tree.map(
                lambda a, b: jnp.where(fuse, a, b), fused, est_state
            )
            est_pos = est_state.x[0:3]
            est_vel = est_state.x[3:6]

        fbk = RobotFeedback(
            torso_pos_world=est_pos,
            torso_quat=quat,
            torso_lin_vel_world=est_vel,
            torso_ang_vel_body=gyro,
            foot_pos_body=foot_body,
            foot_contact=contact_prob,
            joint_pos=q.reshape(-1),
            joint_vel=dq.reshape(-1),
        )

        # ---- plan in the ESTIMATED world frame
        foot_world_est = est_pos + foot_body @ rot.T
        vel_d_rel = jnp.stack([joy.velx, joy.vely, jnp.zeros_like(joy.velx)])
        default_rel = _sp_default_rel(sp, dtype)
        target_world, _ = raibert_mod.foothold_targets(
            est_pos, quat, est_vel, vel_d_rel, default_rel, gait_freq
        )
        if rear_stride_bias > 0.0:
            # stair stride-length adaptation for the REAR pair (measured
            # r5: with a 0.42 m axial hip span over 0.30 m runs, the rear
            # Raibert targets stay behind the riser edge until the rear
            # hips pass it — the rear feet repeatedly land short of the
            # climb while the fronts are already two treads up, and the
            # posture stretches to collapse; a forward bias lets the rear
            # pair commit to the riser crossing a half-stride earlier)
            target_world = target_world.at[2:, 0].add(
                jnp.where(tp.kind == terrain_mod.STAIRS, rear_stride_bias, 0.0)
            )
        target_world = terrain_mod.snap_to_ground(
            tp, target_world, edge_forward=edge_forward
        )

        gait = sched_mod.gait_update(
            carry.gait, pattern, sp.wts.h, jnp.asarray(gait_freq, dtype),
            foot_world_est, target_world, contact_prob > 0.5,
        )
        plan_contacts = sched_mod.contact_flags(gait, pattern).astype(dtype)
        mpc_contacts = plan_contacts
        if per_knot_contacts:
            mpc_contacts = sched_mod.predict_contact_schedule(
                gait, pattern, jnp.asarray(gait_freq, dtype), sp.wts.h,
                horizon + 1
            ).astype(dtype)

        goal, cmd = goals.goal_update(carry.goal, fbk, joy, mpc_contacts,
                                      dt=sp.wts.h)
        n_stance = jnp.maximum(jnp.sum(plan_contacts), 1.0)
        ground_z = jnp.sum(foot_world_est[:, 2] * plan_contacts) / n_stance
        # rear-leg CROUCH scheduling (see factory docstring): stance-foot
        # height spread detects the riser straddle
        target_h = sp.target_height
        if crouch > 0.0:
            stance_z = jnp.where(
                plan_contacts > 0.5, foot_world_est[:, 2],
                jnp.sum(foot_world_est[:, 2] * plan_contacts) / n_stance,
            )
            spread = jnp.max(stance_z) - jnp.min(stance_z)
            target_h = target_h - crouch * jnp.clip(spread / 0.17, 0.0, 1.0)
        cmd = cmd._replace(
            pos_body_d=cmd.pos_body_d.at[2].set(
                ground_z + target_h - est_pos[2]
            )
        )
        if com_shift > 0.0:
            # quasi-static CoM scheduling (see factory docstring): target
            # the lateral centroid of the support polygon a few knots AHEAD
            ahead = (
                mpc_contacts[min(3, horizon)] if per_knot_contacts
                else plan_contacts
            )
            n_ahead = jnp.maximum(jnp.sum(ahead), 1.0)
            y_c = jnp.sum(foot_body[:, 1] * ahead) / n_ahead
            cmd = cmd._replace(
                pos_body_d=cmd.pos_body_d.at[1].add(com_shift * y_c)
            )
        terr_est, pitch_d = kterr_mod.terrain_update(
            carry.terrain_est, foot_world_est - est_pos,
            movement_mode=1, torso_height=est_pos[2] - ground_z,
            contact_weights=plan_contacts,
        )
        if pitch_preview > 0.0:
            # body-pitch PREVIEW from the upcoming foothold targets (sign
            # convention of kin.terrain.terrain_update: front higher ⇒
            # negative pitch = nose up)
            front_t = 0.5 * (target_world[0] + target_world[1])
            rear_t = 0.5 * (target_world[2] + target_world[3])
            sep = jnp.maximum(
                jnp.linalg.norm((front_t - rear_t)[:2]), 0.05
            )
            pitch_tgt = -jnp.arctan2(front_t[2] - rear_t[2], sep)
            pitch_tgt = jnp.clip(pitch_tgt, -kterr_mod.MAX_TERRAIN_ANGLE,
                                 kterr_mod.MAX_TERRAIN_ANGLE)
            pitch_d = pitch_d + pitch_preview * (pitch_tgt - pitch_d)
        eul_d = lie.quat_to_euler(cmd.quat_d)
        cmd = cmd._replace(
            quat_d=lie.euler_to_quat(
                jnp.stack([eul_d[0], eul_d[1] + pitch_d, eul_d[2]])
            )
        )

        out, _sol = grf_update(fbk, cmd, sp.wts)
        out = out._replace(
            grf_body=out.grf_body * plan_contacts[:, None],
            foot_pos_target_world=gait.target_pos,
            foot_vel_target_world=gait.target_vel,
        )
        targets = torque_mod.tau_ctrl_update(fbk, out, ap.rho_fix, plan_contacts)

        # stance: pure torque + damping; swing: full PD (actuated convention)
        # stance anchoring: walk convention is pure torque + damping
        # (kp=0, tau_ctrl_update anchors q_cmd at measured q); a nonzero
        # stance_kp_frac restores a fraction of the position anchor — on
        # stairs a lightly-loaded just-landed foot otherwise slides
        # forward under the horizontal GRF component until it jams into
        # the riser base (measured: 4 cm slide -> corner ring -> kill)
        kp_leg = ap.kp_joint * (
            (1.0 - plan_contacts) + stance_kp_frac * plan_contacts
        )[:, None]
        ap_tick = ap._replace(kp_joint=kp_leg)
        new_robot = art_mod.step(rs, targets, ap_tick, sp.wts.h, n_sub, ext_wrench)

        ground_under = terrain_mod.height(tp, new_robot.torso.pos[:2])
        # collapse check against the SUPPORT height: while the legs straddle
        # a stair riser the terrain point under the torso center jumps a
        # full rise, but the robot stands on its stance feet — min() keeps
        # the mid-straddle climb legal without weakening true-collapse
        # detection (torso sinking toward its stance feet still trips)
        support_z = jnp.minimum(ground_under, ground_z)
        # sustained dq check: rs.dq is the PREVIOUS tick's endpoint
        ok = safety.is_safe_sustained(
            new_robot.torso.quat, new_robot.dq.reshape(-1), rs.dq.reshape(-1)
        )
        ok = ok & safety.finite_state(new_robot.torso) & (
            new_robot.torso.pos[2] - support_z > 0.05
        )
        alive = carry.alive & ok
        kept_robot = jax.tree.map(
            lambda new, old: jnp.where(alive, new, old), new_robot, rs
        )

        yaw = lie.quat_to_euler(kept_robot.torso.quat)[2]
        vel_rel = lie.rotz(yaw).T @ kept_robot.torso.vel
        true_ground = jnp.sum(
            jnp.where(plan_contacts > 0.5,
                      terrain_mod.height(tp, foot_world_est[:, :2]), 0.0)
        ) / n_stance
        metrics = EstActuatedMetrics(
            mpc_cost=out.mpc_cost,
            vel_err=jnp.abs(vel_rel[0] - joy.velx),
            height_err=jnp.abs(
                kept_robot.torso.pos[2] - true_ground - sp.target_height
            ),
            est_err=jnp.linalg.norm(est_pos - ps.pos),
            alive=alive.astype(dtype),
        )
        return (
            EstActuatedCarry(
                robot=kept_robot, goal=goal, gait=gait, terrain_est=terr_est,
                est=est_state, prev_targets=targets, prev_kp=kp_leg,
                prev_vel=ps.vel, tick=carry.tick + 1,
                mocap_count=mocap_count, alive=alive,
            ),
            metrics,
        )

    return control_step


def init_estimated_actuated_scenario(
    wts: quat_mpc.QuatMpcWeights,
    height: float = 0.3,
    dtype=jnp.float32,
    terrain=None,
    kf_type: int = 1,
    pattern=None,
    start_x: float = 0.0,
):
    """Actuated carry + per-kf_type estimator state; the first tick's
    'previous command' is a hold of the initial pose (the prime-servo
    handover state)."""
    from quaternion_mpc_tpu.control import torque as torque_mod
    from quaternion_mpc_tpu.est import ekf as ekf_mod
    from quaternion_mpc_tpu.est import kf as kf_mod
    from quaternion_mpc_tpu.sim import articulated as art_mod

    base, sp = init_actuated_scenario(
        wts, height, dtype, terrain, pattern, start_x
    )
    rs = base.robot
    rot = lie.quat_to_rotmat(rs.torso.quat)
    foot_body, _, _, _ = art_mod.foot_kinematics(rs, sp.plant)
    if kf_type == 1:
        est = kf_mod.init_state(rot, foot_body, dtype=dtype)
        # warm start at the true pose — torso AND foot states (the hardware
        # loop's prime phase does this convergence; here the scenario
        # starts mid-operation). Leaving the feet at the cold 0.09 m prior
        # would drag the torso estimate back through the FK residual.
        feet_w = (foot_body @ rot.T + rs.torso.pos).reshape(-1)
        est = est._replace(
            x=jnp.concatenate(
                [rs.torso.pos, jnp.zeros((3,), dtype), feet_w]
            )
        )
    elif kf_type == 2:
        est = ekf_mod.init_state(
            rs.torso.pos, lie.quat_to_euler(rs.torso.quat), foot_body
        )
    else:
        est = None
    hold = torque_mod.JointTargets(
        q=rs.q, dq=jnp.zeros_like(rs.q), tau=jnp.zeros_like(rs.q)
    )
    carry = EstActuatedCarry(
        robot=rs, goal=base.goal, gait=base.gait, terrain_est=base.terrain_est,
        est=est, prev_targets=hold,
        prev_kp=jnp.broadcast_to(sp.plant.kp_joint, (4, 3)).astype(dtype),
        prev_vel=rs.torso.vel,
        tick=jnp.zeros((), jnp.int32),
        mocap_count=jnp.zeros((), jnp.int32),
        alive=jnp.asarray(True),
    )
    return carry, sp
