"""Hardware-loop runtime: the reference ``main.cpp`` composition as a
running program — an MPC loop and a low-level servo thread exchanging
state through seqlock buses, talking LowCmd/LowState over real UDP
sockets to a robot peer.

Reference shape (cited for parity, not copied):
- ``legged_ctrl/src/main.cpp``: two ROS timer threads — MPC update at
  2.5 ms, low-level ``send_cmd`` at 1 kHz — sharing a ``LeggedState``.
- ``legged_ctrl/src/interfaces/HardwareInterface.cpp:7,82-152``: UDP link
  to 192.168.123.10:8007, joint-order swap on the wire, foot-force
  bias/filter chain, kf_type=1 BasicKF estimation from IMU + legs.
- ``unitree_legged_control/src/joint_controller.cpp:15-229``: the
  firmware-side servo law τ = τ_ff + Kp(q_d−q) + Kd(dq_d−dq).

Composition here: the control tick is ONE jitted pure function
(estimator + goal + MPC + torque map — no blackboard mutation), the
runtime around it is the native C++ layer (``RateLoop`` absolute-deadline
scheduling, ``StateBus`` seqlocks, ``UdpLink`` sockets). The robot peer is
the articulated joint-level plant (`sim.articulated`) integrating the
received servo law — so the demo exercises the full stack: solver →
torque map → wire codec → UDP → firmware PD → contact physics → sensors
→ wire → estimator → solver.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from quaternion_mpc_tpu.control import goals, quat_mpc, standup
from quaternion_mpc_tpu.control import torque as torque_mod
from quaternion_mpc_tpu.control.types import RobotFeedback
from quaternion_mpc_tpu.est import kf as kf_mod
from quaternion_mpc_tpu.kin import leg as leg_mod
from quaternion_mpc_tpu.ops import lie
from quaternion_mpc_tpu.runtime import native, unitree
from quaternion_mpc_tpu.sim import articulated as art_mod
from quaternion_mpc_tpu.sim import terrain as terrain_mod
from quaternion_mpc_tpu.solver import SolverOptions

# default-pose / stand-up servo gains per joint type (hip, thigh, calf) — the
# reference's hard-coded stand gains (GazeboInterface.cpp:85-111)
PRIME_KP = ((70.0, 180.0, 300.0),) * 4
PRIME_KD = ((3.0, 8.0, 15.0),) * 4

# flat f32 sensor frame on the feedback bus:
# quat(4) gyro(3) accel(3) q(12) dq(12) foot_force(4) tick(1)
# The tick counter is the SIM clock: the peer advances dt_low of physics per
# LowCmd served, so (Δtick · dt_low) — not the wall clock — is the dt the
# estimator/goal integrators must use. (On real hardware the two coincide;
# here the reactive peer's clock stretches whenever the servo thread
# overruns, and integrating with wall dt destabilizes the loop.)
_N_SENSOR = 39
_SENSOR_BYTES = _N_SENSOR * 4
# flat f32 command frame on the command bus: (12, 5) [q dq tau kp kd]
_CMD_BYTES = 12 * 5 * 4


class HWSensors(NamedTuple):
    quat: jnp.ndarray        # (4,) IMU attitude [w,x,y,z]
    gyro: jnp.ndarray        # (3,) body rates
    accel: jnp.ndarray       # (3,) specific force, body frame
    q: jnp.ndarray           # (12,) joint angles, controller order
    dq: jnp.ndarray          # (12,)
    foot_force: jnp.ndarray  # (4,) filtered normal forces


class HWCarry(NamedTuple):
    goal: goals.GoalState
    kf: kf_mod.KFState
    mode: goals.ModeState
    standup: standup.StandupState
    gait: "object"  # gait.schedule.GaitState (walk mode, A-toggled)
    prev_grf: "object" = None  # (4,3) body-frame stance GRFs of the last
    # tick's published plan — the input term of the pool-mode lead
    # prediction (see ctrl_core)


def sensors_from_lowstate(st: unitree.LowState, dtype=jnp.float32) -> HWSensors:
    q = np.array([m.q for m in st.motor_state], np.float32)
    dq = np.array([m.dq for m in st.motor_state], np.float32)
    return HWSensors(
        quat=jnp.asarray(st.quaternion, dtype),
        gyro=jnp.asarray(st.gyroscope, dtype),
        accel=jnp.asarray(st.accelerometer, dtype),
        q=jnp.asarray(q, dtype),
        dq=jnp.asarray(dq, dtype),
        foot_force=jnp.asarray(st.foot_force, dtype),
    )


def _sensors_to_bytes(st: unitree.LowState) -> bytes:
    q = [m.q for m in st.motor_state]
    dq = [m.dq for m in st.motor_state]
    flat = np.concatenate([
        np.asarray(st.quaternion, np.float32),
        np.asarray(st.gyroscope, np.float32),
        np.asarray(st.accelerometer, np.float32),
        np.asarray(q, np.float32),
        np.asarray(dq, np.float32),
        np.asarray(st.foot_force, np.float32),
        # tick carried as exact uint32 bits (a float32 tick loses integer
        # exactness past 2^24 ≈ 4.6 h at 1 kHz, quantizing Δtick)
        np.asarray([st.tick], np.uint32).view(np.float32),
    ])
    return flat.tobytes()


def _sensors_from_bytes(data: bytes, dtype=jnp.float32) -> tuple[HWSensors, int]:
    flat = np.frombuffer(data, np.float32, count=_N_SENSOR)
    sensors = HWSensors(
        quat=jnp.asarray(flat[0:4], dtype),
        gyro=jnp.asarray(flat[4:7], dtype),
        accel=jnp.asarray(flat[7:10], dtype),
        q=jnp.asarray(flat[10:22], dtype),
        dq=jnp.asarray(flat[22:34], dtype),
        foot_force=jnp.asarray(flat[34:38], dtype),
    )
    return sensors, int(flat[38:39].view(np.uint32)[0])


def make_hw_control_tick(
    horizon: int = 6,
    opts: SolverOptions = SolverOptions(al_iterations=1, ilqr_iterations=3),
    max_height_cmd_err: float = 0.05,
    gait_freq: float = 2.2,
    pattern=None,
):
    """One jittable hardware control tick with the reference's operator flow:
    sensors → sigmoid contact detection (BaseInterface.cpp:234-249) →
    BasicKF → joystick mode machine (BaseInterface.cpp:135-192) → either
    the default-pose/stand-up servo (set_default_pos, GazeboInterface.cpp:
    85-111 + unitree_controller/src/body.cpp ramp) or goal update +
    quaternion MPC + torque map → (12, 5) servo command [q dq tau kp kd]
    for the wire. An A-press (``joy.mode_switch``) toggles stand ↔ walk:
    walk mode advances the trot FSM on the ESTIMATED foot-world anchors,
    plans Raibert footholds from the estimated velocity, and gates the MPC
    with the per-knot predicted contact schedule; stand mode re-anchors
    the FSM at the current feet every tick so a later walk starts clean.

    ``joy`` is a raw ``goals.JoySample`` (button edges are consumed the tick
    they arrive, reference edge semantics). ``dt`` is a traced scalar — the
    SIM-clock time advanced since the previous tick. This deliberately
    departs from the reference, which passes fixed nominal periods to
    ctrl_update/fbk_update (Main.cpp:101-119): the reactive loopback peer's
    clock stretches whenever the servo thread overruns, so integrating with
    nominal (or wall) dt would double-integrate. dt == 0 marks a repeated
    feedback frame: the KF measurement update is skipped (re-fusing an
    identical measurement would shrink covariance without new data).

    The commanded body-height error is clamped to ±max_height_cmd_err: a
    cold estimator (BasicKF's 0.09 m prior vs a ~0.3 m true height) would
    otherwise command a step-input the size of the estimator error and
    launch the robot — the reference avoids this operationally by holding
    default-pose until the operator engages MPC; the clamp makes the MPC
    phase additionally robust to estimator transients."""
    from quaternion_mpc_tpu.gait import raibert as raibert_mod
    from quaternion_mpc_tpu.gait import schedule as sched_mod

    if pattern is None:
        # trot WITH an all-stance dwell (LeggedContactFSM.cpp:110-150): the
        # dwell is what lets a stop request terminate the gait at a phase
        # where all four feet are planted — the pure 0.5-duty trot never
        # has all-stance, so a stop would either cut a swing pair mid-air
        # or never trigger. It also stabilizes each cycle at this loop's
        # modest 50 Hz control rate.
        pattern = sched_mod.trot_with_stand_pattern()
    grf_update = quat_mpc.make_controller(horizon, opts, zero_initial_omega=False)

    def est_core(kf_state, sensors: HWSensors, dt, rho_fix):
        """Feedback-tier work (the reference's 1 kHz thread, Main.cpp:
        169-199): FK, sigmoid contact detection, BasicKF tick. Pure — runs
        fused inside the two-tier tick or alone in the three-tier
        estimator thread."""
        quat = lie.quat_normalize(sensors.quat)
        rot = lie.quat_to_rotmat(quat)
        q = sensors.q.reshape(4, 3)
        dq = sensors.dq.reshape(4, 3)
        foot_body = leg_mod.fk(q, rho_fix)
        J = leg_mod.jac(q, rho_fix)
        foot_vel_rel = jnp.einsum("lij,lj->li", J, dq)

        # sigmoid contact confidence on filtered foot force
        contact = 1.0 / (1.0 + jnp.exp(-10.0 * (sensors.foot_force - 10.0)))

        kf_new, _, _ = kf_mod.update(
            kf_state,
            kf_mod.KFInputs(
                torso_rot_mat=rot,
                torso_lin_acc_body=sensors.accel,
                torso_ang_vel_body=sensors.gyro,
                foot_pos_body=foot_body,
                foot_lin_vel_rel=foot_vel_rel,
                contacts=contact,
            ),
            jnp.maximum(dt, 1e-6),
        )
        # repeated frame (dt==0): keep the previous estimate untouched
        fresh = dt > 0.0
        kf_out = jax.tree.map(
            lambda new, old: jnp.where(fresh, new, old), kf_new, kf_state
        )
        return kf_out, kf_out.x[0:3], kf_out.x[3:6], contact, foot_body

    def tick(carry: HWCarry, sensors: HWSensors, dt, joy: goals.JoySample,
             wts, rho_fix, kp_joint, kd_joint, lead=0.0):
        kf_state, pos_w, vel_w, _contact, _foot_body = est_core(
            carry.kf, sensors, dt, rho_fix
        )
        return ctrl_core(
            carry, sensors, kf_state, pos_w, vel_w,
            dt, joy, wts, rho_fix, kp_joint, kd_joint, lead,
        )

    def ctrl_core(carry: HWCarry, sensors: HWSensors, kf_state,
                  pos_w, vel_w, dt,
                  joy: goals.JoySample, wts, rho_fix, kp_joint, kd_joint,
                  lead=0.0):
        """MPC-tier work. Takes only the torso pos/vel ESTIMATE from the
        feedback tier; contact detection and foot kinematics are recomputed
        from the freshest sensors HERE — in three-tier mode the gait FSM's
        early-contact logic cannot tolerate estimate-bus staleness (measured:
        contact delayed by one 10 ms est period pumps altitude and falls
        mid-trot, the same failure mode as the 40 ms force filter), and the
        reference's MPC thread likewise reads raw feedback fields off the
        blackboard refreshed at 1 kHz, not a decimated snapshot."""
        dtype = sensors.quat.dtype
        quat = lie.quat_normalize(sensors.quat)
        rot = lie.quat_to_rotmat(quat)
        foot_body = leg_mod.fk(sensors.q.reshape(4, 3), rho_fix)
        contact = 1.0 / (1.0 + jnp.exp(-10.0 * (sensors.foot_force - 10.0)))

        # ---- joystick mode machine (A toggles stand/walk, B default-pose)
        mode, joycmd, movement_mode = goals.joy_mode_update(carry.mode, joy, dt)

        # ---- default-pose / stand-up servo path (set_default_pos)
        # ramp restarts from the measured pose whenever the mode engages
        st_engaged = carry.standup
        st_fresh = standup.init_standup(sensors.q)
        st = jax.tree.map(
            lambda a, b: jnp.where(carry.mode.set_default_pos, a, b),
            st_engaged, st_fresh,
        )
        st, q_ramp, _done = standup.standup_targets(st, dt)
        prime_kp = jnp.asarray(PRIME_KP, dtype).reshape(4, 3)
        prime_kd = jnp.asarray(PRIME_KD, dtype).reshape(4, 3)
        prime_cmd = jnp.stack(
            [
                q_ramp.reshape(4, 3),
                jnp.zeros((4, 3), dtype),
                jnp.zeros((4, 3), dtype),
                prime_kp,
                prime_kd,
            ],
            axis=-1,
        ).reshape(12, 5)

        # ---- lead STATE PREDICTION (pipelined-pool dispatch): the command
        # computed here applies ~lead seconds later; solving from the
        # measured state makes every GRF a stale feedback action (measured:
        # trot commands at ~55 ms staleness march in place while standing
        # balance tolerates it). Predict the torso state to the APPLICATION
        # time with the SRB model under the PREVIOUS tick's realized stance
        # forces — the standard RTI delay-compensation move — and hand the
        # MPC the predicted state. Gait/contact/anchor logic stays on the
        # measured state (phase lead is applied separately below). lead==0
        # reproduces the uncompensated feedback exactly.
        lead_p = jnp.asarray(lead, dtype)
        lead_on = lead_p > 0.0
        prev_f = (
            carry.prev_grf if carry.prev_grf is not None
            else jnp.zeros((4, 3), dtype)
        )
        acc_w = (rot @ jnp.sum(prev_f, axis=0)) / wts.mass + jnp.asarray(
            [0.0, 0.0, -9.81], dtype
        )
        pos_pred = pos_w + vel_w * lead_p + 0.5 * acc_w * lead_p * lead_p
        vel_pred = vel_w + acc_w * lead_p
        quat_pred = lie.quat_normalize(
            quat + 0.5 * lead_p * (lie.quat_G(quat) @ sensors.gyro)
        )
        rot_pred = lie.quat_to_rotmat(quat_pred)
        # stance feet are world-fixed: re-express the SAME world anchors in
        # the predicted body frame
        feet_world_now = pos_w + foot_body @ rot.T
        foot_body_pred = (feet_world_now - pos_pred) @ rot_pred
        pos_mpc = jnp.where(lead_on, pos_pred, pos_w)
        vel_mpc = jnp.where(lead_on, vel_pred, vel_w)
        quat_mpc_ = jnp.where(lead_on, quat_pred, quat)
        foot_body_mpc = jnp.where(lead_on, foot_body_pred, foot_body)

        # ---- MPC path
        fbk = RobotFeedback(
            torso_pos_world=pos_mpc,
            torso_quat=quat_mpc_,
            torso_lin_vel_world=vel_mpc,
            torso_ang_vel_body=sensors.gyro,
            foot_pos_body=foot_body_mpc,
            foot_contact=contact,
            joint_pos=sensors.q,
            joint_vel=sensors.dq,
        )

        # ---- gait: walk mode advances the trot FSM on estimated anchors;
        # stand mode re-anchors it at the current feet (clean walk start).
        # An A-press to stand does NOT cut the gait mid-stride: the FSM
        # keeps running (with zero velocity command) until every foot is
        # back in stance, THEN freezes — the reference FSM's transition-at-
        # phase-boundary semantics (LeggedContactFSM stand pattern). An
        # instant freeze would declare airborne swing feet "stance" and the
        # MPC would load them, tipping the robot roughly half the time
        # depending on where in the stride the press lands.
        walking = movement_mode == 1
        in_swing = sched_mod.contact_flags(carry.gait, pattern) < 0.5
        gait_active = walking | jnp.any(in_swing)
        feet_world_est = pos_w + foot_body @ rot.T
        vel_d_rel = jnp.stack(
            [joycmd.velx, joycmd.vely, jnp.zeros_like(joycmd.velx)]
        )
        default_rel = jnp.asarray(
            [[0.20, 0.14, -0.3], [0.20, -0.14, -0.3],
             [-0.20, 0.14, -0.3], [-0.20, -0.14, -0.3]], dtype=dtype)
        target_world, _ = raibert_mod.foothold_targets(
            pos_w, quat, vel_w, vel_d_rel, default_rel, gait_freq
        )
        target_world = target_world.at[:, 2].set(0.0)  # flat-ground demo
        gait_adv = sched_mod.gait_update(
            carry.gait, pattern, dt, jnp.asarray(gait_freq, dtype),
            feet_world_est, target_world, contact > 0.5,
        )
        gait_hold = sched_mod.init_gait_state(feet_world_est, pattern)
        gait = jax.tree.map(
            lambda a, b: jnp.where(gait_active, a, b), gait_adv, gait_hold
        )
        plan_contacts = jnp.where(
            gait_active,
            sched_mod.contact_flags(gait, pattern).astype(dtype),
            jnp.ones((4,), dtype),
        )
        # Per-knot spacing is the solver discretization wts.h, NOT the
        # measured loop dt: the MPC dynamics integrate at h, so predicted
        # contact switches must land on the same time grid (gait_update
        # above correctly advances phase by the measured dt).
        sched = sched_mod.predict_contact_schedule(
            gait, pattern, jnp.asarray(gait_freq, dtype), wts.h, horizon + 1
        ).astype(dtype)
        mpc_contacts = jnp.where(
            gait_active, sched, jnp.ones((horizon + 1, 4), dtype)
        )

        goal, cmd = goals.goal_update(carry.goal, fbk, joycmd, mpc_contacts, dt=dt)
        height_err = jnp.clip(
            mode.body_height - pos_w[2], -max_height_cmd_err, max_height_cmd_err
        )
        cmd = cmd._replace(pos_body_d=cmd.pos_body_d.at[2].set(height_err))
        out, _sol = grf_update(fbk, cmd, wts)

        # ---- publish-time LEAD compensation (pipelined-pool dispatch):
        # with the puller pool, this command applies ~one result-pull time
        # after the sensors it was computed from. GRFs vary slowly across a
        # 150 ms stance and tolerate that; the SWING targets do not — a
        # 30 ms-stale quintic target at trot frequency drags every step
        # ~13% of its swing behind the gait clock and the trot marches in
        # place (measured). So the TIME-CRITICAL outputs — swing PD
        # targets and the stance/swing joint gating — are evaluated at the
        # phase the command will be APPLIED (phase + lead·freq), while the
        # force plan stays on the solve-time schedule. lead is traced; 0
        # (the synchronous modes) selects the uncompensated outputs
        # exactly.
        lead_t = jnp.asarray(lead, dtype)
        gait_pub_adv = sched_mod.gait_update(
            gait, pattern, lead_t, jnp.asarray(gait_freq, dtype),
            feet_world_est, target_world, contact > 0.5,
        )
        gait_pub = jax.tree.map(
            lambda a, b: jnp.where(gait_active, a, b), gait_pub_adv, gait_hold
        )
        use_lead = lead_t > 0.0
        pub_contacts = jnp.where(
            use_lead & gait_active,
            sched_mod.contact_flags(gait_pub, pattern).astype(dtype),
            plan_contacts,
        )
        pub_target_pos = jnp.where(use_lead, gait_pub.target_pos, gait.target_pos)
        pub_target_vel = jnp.where(use_lead, gait_pub.target_vel, gait.target_vel)

        out = out._replace(
            grf_body=out.grf_body * plan_contacts[:, None],
            foot_pos_target_world=pub_target_pos,
            foot_vel_target_world=pub_target_vel,
        )
        targets = torque_mod.tau_ctrl_update(fbk, out, rho_fix, pub_contacts)

        # standing (movement_mode==0) convention, BaseInterface.cpp:402-405:
        # τ_ff = −Jᵀf AND a full joint PD anchored at the MEASURED q/dq
        # (tau_ctrl_update sets q_cmd=q for stance legs). The anchor is the
        # stabilizer: between command updates the firmware PD resists any
        # drift/foot slide — with kp=0 the pure-torque stance slowly slides
        # the feet until the legs degenerate and the robot falls. Walk-mode
        # stance legs instead run pure torque + damping (the actuated-loop
        # convention — an anchor PD would fight the body motion).
        kp = jnp.broadcast_to(kp_joint, (4, 3))
        kd = jnp.broadcast_to(kd_joint, (4, 3))
        kp = jnp.where(gait_active, kp * (1.0 - pub_contacts)[:, None], kp)
        mpc_cmd = jnp.stack(
            [targets.q, targets.dq, targets.tau, kp, kd], axis=-1
        ).reshape(12, 5)

        # goal state freezes while the default-pose servo holds (the MPC is
        # not in command; integrating its position target would wind up).
        # A B-press takes effect the same tick (joy_update precedes
        # ctrl_update in the reference loop), hence the post-update mode.
        in_prime = mode.set_default_pos
        goal = jax.tree.map(
            lambda new, old: jnp.where(in_prime, old, new), goal, carry.goal
        )
        # prime→MPC handover: re-anchor the desired world position at the
        # (now converged) estimate so MPC starts from zero position error.
        # Same at the walk→stand edge: the position integrator accumulates
        # any walk-phase tracking deficit (it advances at the COMMANDED
        # velocity), and with the reference's xy position weight (2.5 vs
        # 0.1 on velocity, gazebo_go1_quat_mpc.yaml:41-51) a wound-up
        # anchor would drag the robot onward long after the stop command.
        walk_stop = (carry.mode.ctrl_state == 1) & (mode.ctrl_state == 0)
        handover = (carry.mode.set_default_pos & ~in_prime) | walk_stop
        goal = goal._replace(
            torso_pos_d_world=jnp.where(
                handover, pos_w, goal.torso_pos_d_world
            )
        )
        cmd_mat = jnp.where(in_prime, prime_cmd, mpc_cmd)

        info = {
            "mpc_cost": out.mpc_cost,
            "est_pos": pos_w,
            "est_vel": vel_w,
            "movement_mode": movement_mode,
            "in_prime": in_prime,
        }
        return (
            HWCarry(goal=goal, kf=kf_state, mode=mode, standup=st, gait=gait,
                    prev_grf=out.grf_body),
            cmd_mat,
            info,
        )

    # expose the tiers for the three-tier runtime (estimator thread runs
    # est_core alone; the MPC thread runs ctrl_core on published estimates)
    tick.est_core = est_core
    tick.ctrl_core = ctrl_core
    return tick


# flat f32 estimate frame on the estimate bus (three-tier mode):
# pos(3) vel(3) sim_tick(1) — sensors travel on the feedback bus; the MPC
# thread combines the freshest of both
_N_EST = 7
_EST_BYTES = _N_EST * 4


def _est_to_bytes(pos, vel, sim_tick: int) -> bytes:
    flat = np.concatenate([
        np.asarray(pos, np.float32), np.asarray(vel, np.float32),
        np.asarray([sim_tick], np.uint32).view(np.float32),
    ])
    return flat.tobytes()


def _est_from_bytes(data: bytes, dtype=jnp.float32):
    flat = np.frombuffer(data, np.float32, count=_N_EST)
    pos = jnp.asarray(flat[0:3], dtype)
    vel = jnp.asarray(flat[3:6], dtype)
    return pos, vel, int(flat[6:7].view(np.uint32)[0])


class SimGo1Peer(threading.Thread):
    """Simulated robot endpoint: answers each LowCmd datagram with one
    low-level period of articulated joint-level physics and a LowState
    reply (the Gazebo/firmware role in the loopback demo). Reactive — the
    controller's servo thread drives the sim clock, so the demo is free of
    peer-side timing races."""

    def __init__(self, ap: art_mod.ArticulatedParams,
                 rs: art_mod.ArticulatedState,
                 dt_cmd: float, n_sub: int = 32):
        super().__init__(daemon=True)
        self.udp = native.UdpLink()  # no peer: learns it from first datagram
        self._ap = ap
        self._rs = rs
        self._dt = float(dt_cmd)
        self._stop_evt = threading.Event()
        self.cmds_served = 0

        def peer_step(rs, cmd_mat):
            cm = cmd_mat.reshape(4, 3, 5)
            targets = torque_mod.JointTargets(
                q=cm[..., 0], dq=cm[..., 1], tau=cm[..., 2]
            )
            ap_t = ap._replace(kp_joint=cm[..., 3], kd_joint=cm[..., 4])
            new_rs = art_mod.step(rs, targets, ap_t, self._dt, n_sub)
            _, foot_world, foot_vel_world, _ = art_mod.foot_kinematics(new_rs, ap)
            f_world, _ = art_mod.contact_forces(
                foot_world, foot_vel_world, ap, new_rs.anchor
            )
            n_vec = terrain_mod.normal(ap.terrain, foot_world[..., :2])
            f_normal = jnp.sum(f_world * n_vec, axis=-1)
            # IMU specific force from the torso velocity delta
            a_world = (new_rs.torso.vel - rs.torso.vel) / self._dt
            rot = lie.quat_to_rotmat(new_rs.torso.quat)
            accel_body = rot.T @ (a_world + jnp.array([0.0, 0.0, 9.81], a_world.dtype))
            obs = (new_rs.torso.quat, new_rs.torso.omega, accel_body,
                   new_rs.q.reshape(-1), new_rs.dq.reshape(-1), f_normal)
            return new_rs, obs

        self._step = jax.jit(peer_step)
        # warm the compile cache before the servo thread starts the clock
        self._rs, _ = jax.block_until_ready(
            self._step(self._rs, jnp.zeros((12, 5), self._rs.q.dtype))
        )

    @property
    def state(self) -> art_mod.ArticulatedState:
        return self._rs

    def stop(self):
        self._stop_evt.set()

    def run(self):
        tick = 0
        while not self._stop_evt.is_set():
            data = self.udp.recv(4096)
            if data is None:
                time.sleep(0.0002)
                continue
            try:
                cmd = unitree.unpack_low_cmd(data)
            except ValueError:
                continue
            cmd_mat = np.array(
                [[m.q, m.dq, m.tau, m.Kp, m.Kd] for m in cmd.motor_cmd],
                np.float32,
            )
            self._rs, obs = self._step(self._rs, jnp.asarray(cmd_mat))
            quat, gyro, accel, q, dq, ff = [np.asarray(o) for o in obs]
            st = unitree.LowState(
                quaternion=quat, gyroscope=gyro, accelerometer=accel,
                foot_force=ff, tick=tick,
            )
            for i in range(12):
                st.motor_state[i].q = float(q[i])
                st.motor_state[i].dq = float(dq[i])
            self.udp.send(unitree.pack_low_state(st))
            self.cmds_served += 1
            tick += 1


def run_hardware_loopback(
    duration_s: float = 1.0,
    mpc_rate: float = 50.0,
    low_rate: float = 250.0,
    est_rate: float = 0.0,
    horizon: int = 6,
    opts: Optional[SolverOptions] = None,
    target_height: float = 0.3,
    realtime_priority: Optional[int] = None,
    prime_s: float = 0.6,
    walk_s: float = 0.0,
    velx: float = 0.3,
    auto_rate: bool = True,
    debug_trace: bool = False,
    dtype=jnp.float32,
    joy_provider=None,
    state_sink=None,
    async_mpc: bool = False,
    async_pullers: int = 0,
) -> dict:
    """Run the full Main.cpp-shaped stack against the simulated peer.

    Threads: [peer: UDP robot sim] ← UDP → [servo thread: RateLoop at
    low_rate, cmd bus → LowCmd, LowState → feedback bus] ↔ seqlock buses ↔
    [main thread: RateLoop at mpc_rate, jitted estimator+MPC+torque tick].

    ``est_rate > 0`` enables the THREE-tier shape of the reference
    (Main.cpp:88-207: MPC prio 50 / low-level prio 25 / feedback prio 10):
    a dedicated estimator thread runs FK + contact detection + BasicKF at
    ``est_rate`` (clamped to ≥ mpc_rate; the reference runs feedback at
    1 kHz) against the freshest sensor frame and publishes estimates on a
    third seqlock bus; the MPC thread consumes the freshest ESTIMATE
    instead of folding the KF into its own tick. The estimator then fuses
    every servo-rate sensor frame rather than one in
    low_rate/mpc_rate — fresher velocity estimates at each MPC tick is
    exactly the margin the 50 Hz trot needs.

    Operator flow (reference parity, BaseInterface.cpp:135-192): the run
    scripts the joystick — a B-press engages the default-pose/stand-up servo
    for ``prime_s`` seconds (the estimator converges from its cold 0.09 m
    prior while the per-joint-type stand gains hold the pose), then a second
    B-press hands over to MPC standing balance for ``duration_s``; with
    ``walk_s > 0`` an A-press then engages the trot at ``velx`` m/s for
    ``walk_s`` seconds and a final A-press returns to standing for another
    ``duration_s`` (the full stand → walk → stand flow over the wire).

    ``joy_provider``: optional callable ``(k, scripted_joy) -> JoySample``
    overriding the scripted operator — the hook the high-level teleop
    bridge drives (`runtime.teleop.HighLevelBridge`). ``state_sink``:
    optional callable ``(k, info, sensors)`` invoked after every MPC tick
    with the estimate/info dict — the HighState publishing hook.

    ``async_mpc``: pipelined one-tick-delay dispatch — each tick's solve is
    dispatched without blocking and the PREVIOUS tick's command is
    published while it computes, so the loop rate is bounded by solve
    THROUGHPUT instead of the dispatch round-trip latency. On a backend
    with a large dispatch floor this is the mitigation that recovers rate;
    the cost is one control period of command latency (the sync
    operator-flow test passes under exactly that injected latency).
    auto_rate then keys on the measured PIPELINED per-tick time.

    ``async_pullers > 0``: the PIPELINED-POOL dispatch mode, which hides a
    slow result pull: when pulling even a READY device value to the host
    takes time T, a single thread is capped at 1/T ticks per second
    regardless of pipeline depth, but CONCURRENT pulls overlap. The MPC
    thread only DISPATCHES and hands the unpulled device command to a pool
    of P puller threads; each puller waits for its result off the critical
    path and publishes to the command bus under a sequence guard
    (publish-if-newer — pulls may complete out of order). Command staleness
    is ~T (recorded in the summary); the command RATE reaches min(P/T,
    enqueue rate). Implies the one-tick-delay semantics of ``async_mpc``
    (which this supersedes when set).

    ``auto_rate``: if the measured (warm) control-tick wall time cannot fit
    the requested MPC period, the MPC rate is lowered to the largest rate
    the platform sustains, and the summary records both. Set False to keep
    the requested rate and count the overruns honestly.

    Returns a summary dict (rates achieved, estimator error, drift speed,
    height error, overrun counts) for the CLI and tests.
    """
    if opts is None:
        opts = SolverOptions(al_iterations=1, ilqr_iterations=3)
    dt_ctrl = 1.0 / mpc_rate
    dt_low = 1.0 / low_rate

    from quaternion_mpc_tpu.utils import config as cfg_mod

    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    terrain = terrain_mod.make_terrain("flat", dtype=dtype)
    ap = art_mod.default_params(
        wts.mass, wts.inertia, wts.com_offset, wts.trunk_mass, terrain, dtype
    )
    rs = art_mod.init_state(height=target_height, rho_fix=ap.rho_fix, dtype=dtype)

    peer = SimGo1Peer(ap, rs, dt_cmd=dt_low, n_sub=max(2, int(round(dt_low / 0.000125))))
    peer.start()

    link = unitree.HardwareLink("127.0.0.1", peer.udp.local_port)
    # sim peer has no force offset (bias_samples=0). Force-filter window:
    # the reference smooths noisy hardware force sensors over 40 ms
    # (40 samples at ITS 1 kHz rate, HardwareInterface.cpp:139-152); here
    # the gait FSM runs at only ~50 Hz, where 40 ms of contact-detection
    # lag mistimes the early-contact transitions enough to pump altitude
    # and fall mid-trot (measured: 1/3 walk survival at 40 ms vs 4/4 at
    # ≤8 ms). The sim's forces are clean, so 8 ms keeps the filter
    # mechanism exercised without the destabilizing lag.
    link.force_proc = unitree.FootForceProcessor(
        bias_samples=0, window=max(1, int(round(0.008 * low_rate)))
    )

    cmd_bus = native.StateBus(_CMD_BYTES)
    fbk_bus = native.StateBus(_SENSOR_BYTES)
    stop_evt = threading.Event()
    servo_stats = {"ticks": 0, "states": 0, "overruns": 0}

    def servo_loop():
        loop = native.RateLoop(dt_low, realtime_priority)
        last_seq = 0
        while not stop_evt.is_set():
            loop.wait()
            seq, data = cmd_bus.read()
            if seq > 0:
                flat = np.frombuffer(data, np.float32, count=60).reshape(12, 5)
                cmd = unitree.LowCmd()
                for i in range(12):
                    m = cmd.motor_cmd[i]
                    m.q, m.dq, m.tau, m.Kp, m.Kd = [float(v) for v in flat[i]]
                link.send_cmd(cmd)
                last_seq = seq
            # drain to the freshest LowState
            st = None
            while True:
                nxt = link.recv_state()
                if nxt is None:
                    break
                st = nxt
            if st is not None:
                fbk_bus.write(_sensors_to_bytes(st))
                servo_stats["states"] += 1
            servo_stats["ticks"] += 1
        servo_stats["overruns"] = loop.overruns

    servo = threading.Thread(target=servo_loop, daemon=True)
    servo.start()

    # first servo tick has no command yet — hold the initial pose with the
    # reference's per-joint-type stand gains (GazeboInterface.cpp:85-111).
    # A damping-only prime lets the robot collapse during the seconds the
    # control tick spends compiling.
    hold = np.zeros((12, 5), np.float32)
    hold[:, 0] = np.asarray(rs.q, np.float32).reshape(-1)
    hold[:, 3] = np.asarray(PRIME_KP, np.float32).reshape(-1)
    hold[:, 4] = np.asarray(PRIME_KD, np.float32).reshape(-1)
    cmd_bus.write(hold.tobytes())

    # wait for the first sensor frame through the full UDP round trip
    t0 = time.time()
    while time.time() - t0 < 5.0:
        seq, data = fbk_bus.read()
        if seq > 0:
            break
        time.sleep(0.002)
    else:  # pragma: no cover - startup failure path
        stop_evt.set()
        peer.stop()
        raise TimeoutError("no LowState received from the sim peer")

    sensors0, tick0 = _sensors_from_bytes(data, dtype)
    rot0 = lie.quat_to_rotmat(lie.quat_normalize(sensors0.quat))
    foot_body0 = leg_mod.fk(sensors0.q.reshape(4, 3), ap.rho_fix)
    fbk0 = RobotFeedback(
        torso_pos_world=jnp.array([0.0, 0.0, 0.09], dtype),  # KF prior (BasicKF.cpp:59)
        torso_quat=lie.quat_normalize(sensors0.quat),
        torso_lin_vel_world=jnp.zeros(3, dtype),
        torso_ang_vel_body=sensors0.gyro,
        foot_pos_body=foot_body0,
        foot_contact=jnp.ones(4, dtype),
        joint_pos=sensors0.q,
        joint_vel=sensors0.dq,
    )
    from quaternion_mpc_tpu.gait import schedule as sched_mod

    feet_world0 = jnp.array([0.0, 0.0, 0.09], dtype) + foot_body0 @ rot0.T
    carry = HWCarry(
        # goal filter window: the reference's MovingWindowFilter(100) at its
        # 200 Hz goal rate is 0.5 s of smoothing (QuatMpc.cpp:10-11); scale
        # the sample count to THIS loop's rate or a stop command takes
        # 100/mpc_rate seconds to decay and the robot keeps walking.
        # Sized from the REQUESTED rate: auto_rate may lower the realized
        # rate later, but the window length is a static jit shape and
        # resizing it would force a recompile of the already-warmed tick —
        # a slightly longer decay on a degraded backend is the cheaper evil.
        goal=goals.init_goal_state(
            fbk0, window=max(1, int(round(0.5 * mpc_rate)))
        ),
        kf=kf_mod.init_state(rot0, foot_body0, dtype=dtype),
        mode=goals.init_mode_state(target_height, dtype),
        standup=standup.init_standup(sensors0.q),
        prev_grf=jnp.zeros((4, 3), dtype),
        gait=sched_mod.init_gait_state(feet_world0, sched_mod.trot_with_stand_pattern()),
    )
    joy_neutral = goals.neutral_joy_sample(dtype)
    joy_press_b = joy_neutral._replace(default_pos=jnp.asarray(True))

    fused = make_hw_control_tick(horizon, opts)
    three_tier = est_rate > 0.0
    dt0 = jnp.asarray(dt_ctrl, dtype)
    # lead is a TRACED argument of the tick (publish-time compensation,
    # see ctrl_core): pass it at EVERY call site so warmup and main loop
    # share one compiled program (a defaulted python float would bake a
    # second, lead=0-constant executable and double the compile).
    lead0 = jnp.zeros((), dtype)
    if three_tier:
        est_jit = jax.jit(fused.est_core)
        ctrl_jit = jax.jit(fused.ctrl_core)
        # warm both tiers, time the MPC tier (it sets the loop rate)
        kf0 = carry.kf
        kf_w, pos_w0, vel_w0, _c, _f = est_jit(
            kf0, sensors0, dt0, ap.rho_fix
        )
        jax.block_until_ready(pos_w0)
        carry_w, cmd_mat, info = ctrl_jit(
            carry, sensors0, kf_w, pos_w0, vel_w0,
            dt0, joy_neutral, wts, ap.rho_fix, ap.kp_joint, ap.kd_joint,
            lead0,
        )
        jax.block_until_ready(cmd_mat)
        t0 = time.perf_counter()
        for _ in range(3):
            _, cmd_w, _ = ctrl_jit(
                carry, sensors0, kf_w, pos_w0, vel_w0,
                dt0, joy_neutral, wts, ap.rho_fix, ap.kp_joint, ap.kd_joint,
                lead0,
            )
            np.asarray(cmd_w)
        tick_wall = (time.perf_counter() - t0) / 3.0
        t0 = time.perf_counter()
        for _ in range(3):
            kf_t, pos_t, _, _, _ = est_jit(kf0, sensors0, dt0, ap.rho_fix)
            np.asarray(pos_t)
        est_wall = (time.perf_counter() - t0) / 3.0
    else:
        tick_fn = jax.jit(fused)
        # warm the compile cache outside the timed loop, and measure the warm
        # tick wall time (includes the backend dispatch floor)
        carry_w, cmd_mat, info = tick_fn(
            carry, sensors0, dt0, joy_neutral, wts, ap.rho_fix,
            ap.kp_joint, ap.kd_joint, lead0,
        )
        jax.block_until_ready(cmd_mat)
        t0 = time.perf_counter()
        for _ in range(3):
            _, cmd_w, _ = tick_fn(
                carry, sensors0, dt0, joy_neutral, wts, ap.rho_fix,
                ap.kp_joint, ap.kd_joint, lead0,
            )
            np.asarray(cmd_w)  # include the device->host pull the loop pays
        tick_wall = (time.perf_counter() - t0) / 3.0
        est_wall = 0.0

    tick_wall_sync = tick_wall
    if async_mpc:
        # pipelined per-tick time: dispatch a chain pulling only the LAST
        # result — the rate bound the one-tick-delay loop actually pays.
        # Measured for BOTH tick shapes (fused single-tier and the
        # three-tier ctrl_core), since the main loop applies the one-slot
        # pipeline in both modes — keying auto_rate on the sync wall time
        # with --async_mpc --est_rate set would forfeit the rate recovery.
        t0 = time.perf_counter()
        if three_tier:
            c_w = carry
            cmd_last = None
            for _ in range(4):
                c_w, cmd_last, _ = ctrl_jit(
                    c_w, sensors0, kf_w, pos_w0, vel_w0,
                    dt0, joy_neutral, wts, ap.rho_fix, ap.kp_joint,
                    ap.kd_joint, lead0,
                )
            np.asarray(cmd_last)
        else:
            c_w = carry
            cmd_last = None
            for _ in range(4):
                c_w, cmd_last, _ = tick_fn(
                    c_w, sensors0, dt0, joy_neutral, wts, ap.rho_fix,
                    ap.kp_joint, ap.kd_joint, lead0,
                )
            np.asarray(cmd_last)
        tick_wall = (time.perf_counter() - t0) / 4.0

    if async_pullers > 0:
        # pool mode rate bound: the MPC thread pays only the ENQUEUE cost
        # per tick; the pool sustains async_pullers concurrent pulls of one
        # RTT each. Measure the enqueue cost on the live tick program.
        c_w2 = carry
        t0 = time.perf_counter()
        for _ in range(8):
            if three_tier:
                c_w2, cmd_enq, _ = ctrl_jit(
                    c_w2, sensors0, kf_w, pos_w0, vel_w0,
                    dt0, joy_neutral, wts, ap.rho_fix, ap.kp_joint,
                    ap.kd_joint, lead0,
                )
            else:
                c_w2, cmd_enq, _ = tick_fn(
                    c_w2, sensors0, dt0, joy_neutral, wts, ap.rho_fix,
                    ap.kp_joint, ap.kd_joint, lead0,
                )
        enqueue_wall = (time.perf_counter() - t0) / 8.0
        np.asarray(cmd_enq)  # drain the chain
        rtt = max(tick_wall_sync, 1e-4)
        pool_tick = max(enqueue_wall, rtt / async_pullers)
        tick_wall = pool_tick
    else:
        enqueue_wall = 0.0

    # publish-time lead for the compensated tick outputs: in pool mode a
    # command applies ~one RTT (the sync tick wall) after its sensors
    lead_run = jnp.asarray(
        tick_wall_sync if async_pullers > 0 else 0.0, dtype
    )

    mpc_rate_req = mpc_rate
    if auto_rate and tick_wall > 0.8 * dt_ctrl:
        dt_ctrl = tick_wall / 0.8
        mpc_rate = 1.0 / dt_ctrl

    est_rate_req = est_rate
    est_stats = {"ticks": 0, "updates": 0, "overruns": 0}
    if three_tier:
        # estimator ≥ MPC rate always (it feeds the MPC); degrade from the
        # requested rate only if the measured est tick cannot fit
        est_rate = max(est_rate, mpc_rate)
        if auto_rate and est_wall > 0.8 / est_rate:
            est_rate = max(mpc_rate, 0.8 / est_wall)
        dt_est = 1.0 / est_rate
        est_bus = native.StateBus(_EST_BYTES)
        pack_est = jax.jit(lambda p, v: jnp.concatenate([p, v]))

        def est_loop():
            loop = native.RateLoop(dt_est, realtime_priority)
            kf_state = carry.kf
            last_tick_e = tick0
            while not stop_evt.is_set():
                loop.wait()
                seq, data = fbk_bus.read()
                if seq == 0:
                    continue
                sensors_e, sim_tick_e = _sensors_from_bytes(data, dtype)
                dt_e = min(
                    max(sim_tick_e - last_tick_e, 0) * dt_low, 5.0 * dt_est
                )
                last_tick_e = sim_tick_e
                kf_state, pos_e, vel_e, _c, _f = est_jit(
                    kf_state, sensors_e, jnp.asarray(dt_e, dtype), ap.rho_fix
                )
                # ONE device pull per est tick: on a high-RTT backend every
                # pull costs a full round trip (see the pool-mode notes),
                # so pos+vel come back as a single packed vector
                pv = np.asarray(pack_est(pos_e, vel_e))
                est_bus.write(_est_to_bytes(pv[:3], pv[3:6], sim_tick_e))
                est_stats["ticks"] += 1
                if dt_e > 0:
                    est_stats["updates"] += 1
            est_stats["overruns"] = loop.overruns

        est_thread = threading.Thread(target=est_loop, daemon=True)
        est_thread.start()
        # wait for the first published estimate
        t0 = time.time()
        while time.time() - t0 < 5.0:
            seq, _ = est_bus.read()
            if seq > 0:
                break
            time.sleep(0.002)
        else:  # pragma: no cover - startup failure path
            stop_evt.set()
            peer.stop()
            raise TimeoutError("estimator thread published no estimate")

    n_prime = max(1, int(round(prime_s * mpc_rate)))
    n_ticks = max(1, int(round(duration_s * mpc_rate)))
    n_walk = int(round(walk_s * mpc_rate))
    # phase boundaries: prime | stand | [walk | stand]
    t_walk_on = n_prime + n_ticks
    t_walk_off = t_walk_on + n_walk
    total = t_walk_off + (n_ticks if n_walk else 0)
    joy_press_a = joy_neutral._replace(mode_switch=jnp.asarray(True))
    joy_walk = joy_neutral._replace(velx=jnp.asarray(velx, dtype))
    loop = native.RateLoop(dt_ctrl, realtime_priority)
    pending = None  # async_mpc one-slot pipeline (cmd, info) of tick k-1

    # pipelined-pool mode: puller threads pay the result-pull RTT off the
    # MPC thread's critical path (see docstring). Sequence-guarded publish;
    # per-tick results recorded for post-hoc bookkeeping.
    use_pool = async_pullers > 0
    pub_state = {"last_k": -1, "published": 0, "stale_dropped": 0,
                 "enqueue_dropped": 0, "staleness": []}
    pub_lock = threading.Lock()
    res_by_k = {}
    true_by_k = {}
    work_q = None
    pool = []
    if use_pool:
        import queue as _queue

        work_q = _queue.Queue(maxsize=4 * async_pullers)
        cmd_shape = tuple(np.asarray(cmd_mat).shape)
        cmd_size = int(np.prod(cmd_shape))

        # ONE device->host transfer per tick: cmd + est_pos + cost are
        # packed into a single device vector at dispatch time instead of
        # three sequential pulls in the puller.
        @jax.jit
        def _pack(c, p, q):
            return jnp.concatenate(
                [c.ravel(), p, jnp.reshape(q, (1,))]
            ).astype(jnp.float32)

        def _puller():
            while True:
                item = work_q.get()
                if item is None:
                    return
                k_i, packed_i, info_i, sensors_i, t_disp = item
                buf = np.asarray(packed_i)  # the one RTT per tick
                cmd_np = buf[:cmd_size].reshape(cmd_shape)
                with pub_lock:
                    if k_i > pub_state["last_k"]:
                        cmd_bus.write(cmd_np.tobytes())
                        pub_state["last_k"] = k_i
                        pub_state["published"] += 1
                        pub_state["staleness"].append(
                            time.perf_counter() - t_disp
                        )
                    else:
                        pub_state["stale_dropped"] += 1
                with pub_lock:
                    res_by_k[k_i] = (
                        buf[cmd_size : cmd_size + 3], float(buf[-1])
                    )
                if state_sink is not None:
                    state_sink(k_i, info_i, sensors_i)

        pool = [
            threading.Thread(target=_puller, daemon=True)
            for _ in range(async_pullers)
        ]
        for t in pool:
            t.start()
    # real-time hygiene: a CPython gen-2 GC pause (10+ ms when a long
    # process has a large live heap, e.g. late in a test session) lands
    # inside the 6.7 ms estimator period and trips the whole pipeline —
    # collect once, then hold GC off for the RT section like any
    # deployed RT Python loop would
    import gc

    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    costs, est_err = [], []
    mpc_pos0 = stand_last = None  # stand-phase endpoints (drift metric)
    walk_start = walk_end = None
    trace = []
    last_tick = tick0
    last_est = last_true = np.zeros(3)
    for k in range(total):
        loop.wait()
        seq, data = fbk_bus.read()
        sensors, sim_tick = _sensors_from_bytes(data, dtype)
        if three_tier:
            _eseq, edata = est_bus.read()
            pos_e, vel_e, _etick = _est_from_bytes(edata, dtype)
        # sim-clock dt (see _N_SENSOR comment); 0 when the frame is a
        # repeat (the tick then skips the KF measurement update), capped at
        # 5 nominal periods after a stall
        dt_sim = min(max(sim_tick - last_tick, 0) * dt_low, 5.0 * dt_ctrl)
        last_tick = sim_tick
        # scripted operator: B on/off around the prime window, A on/off
        # around the walk window
        if k in (0, n_prime):
            joy = joy_press_b
        elif n_walk and k == t_walk_on:
            joy = joy_press_a._replace(velx=joy_walk.velx)
        elif n_walk and k == t_walk_off:
            joy = joy_press_a
        elif n_walk and t_walk_on < k < t_walk_off:
            joy = joy_walk
        else:
            joy = joy_neutral
        if joy_provider is not None:
            joy = joy_provider(k, joy)
        if three_tier:
            carry, cmd_mat, info = ctrl_jit(
                carry, sensors, carry.kf, pos_e, vel_e,
                jnp.asarray(dt_sim, dtype), joy, wts,
                ap.rho_fix, ap.kp_joint, ap.kd_joint, lead_run,
            )
        else:
            carry, cmd_mat, info = tick_fn(
                carry, sensors, jnp.asarray(dt_sim, dtype), joy, wts,
                ap.rho_fix, ap.kp_joint, ap.kd_joint, lead_run,
            )
        if use_pool:
            # pipelined-pool mode: enqueue only — the pull RTT is paid by
            # a puller thread off this loop's critical path. Bookkeeping
            # (cost/est pairing) is assembled post-hoc from res_by_k.
            true_pos = np.asarray(peer.state.torso.pos)
            true_by_k[k] = true_pos
            last_true = true_pos
            packed = _pack(cmd_mat, info["est_pos"], info["mpc_cost"])
            try:
                work_q.put_nowait(
                    (k, packed, info, sensors, time.perf_counter())
                )
            except Exception:
                pub_state["enqueue_dropped"] += 1  # pool saturated: skip tick
            if n_prime <= k < t_walk_on:
                if mpc_pos0 is None:
                    mpc_pos0 = true_pos
                stand_last = true_pos
            if n_walk and k == t_walk_on:
                walk_start = true_pos
            if n_walk and k == t_walk_off:
                walk_end = true_pos
            continue
        if async_mpc:
            # pipelined one-tick-delay mode: dispatch tick k WITHOUT
            # pulling; publish tick k-1's command (now surely finished)
            # while k computes. The carry feeds forward as unpulled device
            # arrays (JAX async dataflow), so the host only ever blocks on
            # a solve that has had a full period to finish. The sync
            # operator-flow test already proves the control law tolerates
            # a full tick of command latency; bookkeeping lags one tick.
            fresh = (cmd_mat, info)
            if pending is None:
                pending = fresh
                continue
            cmd_mat, info = pending
            pending = fresh
        cmd_np = np.asarray(cmd_mat, np.float32)
        cmd_bus.write(cmd_np.tobytes())
        if state_sink is not None:
            state_sink(k, info, sensors)
        true_pos = np.asarray(peer.state.torso.pos)
        last_est = np.asarray(info["est_pos"])
        last_true = true_pos
        if n_prime <= k < t_walk_on:
            if mpc_pos0 is None:
                mpc_pos0 = true_pos
            stand_last = true_pos
            costs.append(float(info["mpc_cost"]))
            est_err.append(float(np.linalg.norm(last_est - true_pos)))
        if n_walk and k == t_walk_on:
            walk_start = true_pos
        if n_walk and k == t_walk_off:
            walk_end = true_pos
        if debug_trace:
            st_now = peer.state
            trace.append({
                "k": k, "dt_sim": round(dt_sim, 4),
                "mode": int(info["movement_mode"]),
                "prime": bool(info["in_prime"]),
                "pos": [round(float(v), 4) for v in st_now.torso.pos],
                "qw": round(float(abs(st_now.torso.quat[0])), 4),
                "vel": [round(float(v), 3) for v in st_now.torso.vel],
            })
    mpc_overruns = loop.overruns
    if gc_was_enabled:
        gc.enable()

    if use_pool:
        for _ in pool:
            work_q.put(None)
        for t in pool:
            t.join(timeout=15.0)
        # post-hoc bookkeeping: pair pulled estimates with the true
        # positions the main thread recorded at dispatch time
        for k_i in sorted(res_by_k):
            if n_prime <= k_i < t_walk_on and k_i in true_by_k:
                est_p, cost_i = res_by_k[k_i]
                costs.append(cost_i)
                est_err.append(
                    float(np.linalg.norm(est_p - true_by_k[k_i]))
                )
        if res_by_k:
            last_est = res_by_k[max(res_by_k)][0]

    stop_evt.set()
    servo.join(timeout=2.0)
    if three_tier:
        est_thread.join(timeout=2.0)
    peer.stop()
    peer.join(timeout=2.0)

    final = peer.state
    height = float(final.torso.pos[2])
    quat_w = float(abs(final.torso.quat[0]))
    mpc_span_s = n_ticks * dt_ctrl
    drift = (
        float(np.linalg.norm((stand_last - mpc_pos0)[:2])) / mpc_span_s
        if mpc_pos0 is not None else float("nan")
    )
    return {
        "mpc_rate_requested": mpc_rate_req,
        "mpc_rate_used": mpc_rate,
        "three_tier": three_tier,
        "est_rate_requested": est_rate_req,
        "est_rate_used": est_rate if three_tier else mpc_rate,
        "est_ticks": est_stats["ticks"],
        "est_updates": est_stats["updates"],
        "est_overruns": int(est_stats["overruns"]),
        "est_tick_wall_ms": est_wall * 1e3,
        "tick_wall_ms": tick_wall * 1e3,
        "tick_wall_sync_ms": tick_wall_sync * 1e3,
        "async_mpc": async_mpc,
        "async_pullers": async_pullers,
        "cmds_published": pub_state["published"],
        "cmds_stale_dropped": pub_state["stale_dropped"],
        "cmds_enqueue_dropped": pub_state["enqueue_dropped"],
        "publish_staleness_ms_p50": (
            float(np.median(pub_state["staleness"]) * 1e3)
            if pub_state["staleness"] else 0.0
        ),
        "enqueue_wall_ms": enqueue_wall * 1e3,
        "prime_ticks": n_prime,
        "mpc_ticks": n_ticks,
        "mpc_overruns": int(mpc_overruns),
        "servo_ticks": servo_stats["ticks"],
        "servo_states": servo_stats["states"],
        "servo_overruns": int(servo_stats["overruns"]),
        "peer_cmds_served": peer.cmds_served,
        "final_height": height,
        "height_err": abs(height - target_height),
        "final_quat_w": quat_w,
        "mean_mpc_cost": float(np.mean(costs)),
        "final_est_err": est_err[-1],
        "drift_speed_mps": drift,
        "final_est_pos": [float(v) for v in last_est],
        "final_true_pos": [float(v) for v in last_true],
        "walk_ticks": n_walk,
        "walk_distance_m": (
            float(np.linalg.norm((walk_end - walk_start)[:2]))
            if walk_end is not None else 0.0
        ),
        "upright": quat_w > 0.95 and height > 0.15,
        **({"trace": trace} if debug_trace else {}),
    }
