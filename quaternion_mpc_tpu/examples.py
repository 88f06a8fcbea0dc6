"""Canonical example scenario builders (host-side, numpy).

Used by the benchmark, the CLI, and the entry points. Built in numpy on the
host, so the inputs reach the device in one transfer.
"""

from __future__ import annotations

import numpy as np

# Go1 default stance feet, body frame (TestAltroQuatMpc.cpp:41-44)
GO1_STANCE_FEET = np.array(
    [
        [0.2104, 0.13, -0.325],
        [0.2104, -0.13, -0.325],
        [-0.1658, 0.13, -0.325],
        [-0.1658, -0.13, -0.325],
    ]
)


def np_euler_to_quat(rpy: np.ndarray) -> np.ndarray:
    """Host-side ZYX euler -> [w,x,y,z] quaternion (pure numpy)."""
    r, p, y = rpy[..., 0] / 2, rpy[..., 1] / 2, rpy[..., 2] / 2
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def standing_batch(batch: int, horizon: int, dtype, seed: int = 0,
                   controller: str = "quat"):
    """A batch of perturbed Go1 standing scenarios for the MPC step:
    (RobotFeedback, Command, weights) pytrees, batch-leading. ``controller``
    selects QuatMpcWeights (default) or ConvexMpcWeights."""
    import jax
    import jax.numpy as jnp

    from quaternion_mpc_tpu.control import quat_mpc
    from quaternion_mpc_tpu.control.types import Command, RobotFeedback
    from quaternion_mpc_tpu.utils import config as cfg_mod

    rng = np.random.default_rng(seed)
    if controller == "convex":
        from quaternion_mpc_tpu.control import convex_mpc

        wts = convex_mpc.weights_from_config(
            cfg_mod.gazebo_go1_convex_mpc(), dtype=dtype
        )
    else:
        wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)

    foot = GO1_STANCE_FEET.astype(dtype)
    rpy = 0.05 * rng.standard_normal((batch, 3)).astype(dtype)
    quat = np_euler_to_quat(rpy)
    fbk = RobotFeedback(
        torso_pos_world=np.tile(np.array([0, 0, 0.3], dtype=dtype), (batch, 1)),
        torso_quat=quat.astype(dtype),
        torso_lin_vel_world=0.05 * rng.standard_normal((batch, 3)).astype(dtype),
        torso_ang_vel_body=0.05 * rng.standard_normal((batch, 3)).astype(dtype),
        foot_pos_body=np.tile(foot, (batch, 1, 1)),
        foot_contact=np.ones((batch, 4), dtype=dtype),
        joint_pos=np.zeros((batch, 12), dtype=dtype),
        joint_vel=np.zeros((batch, 12), dtype=dtype),
    )
    ident = np.tile(np.array([1, 0, 0, 0], dtype=dtype), (batch, 1))
    cmd = Command(
        pos_body_d=np.zeros((batch, 3), dtype=dtype),
        lin_vel_body_d=np.zeros((batch, 3), dtype=dtype),
        quat_d=ident,
        ang_vel_body_d=np.zeros((batch, 3), dtype=dtype),
        contacts=np.ones((batch, 4), dtype=dtype),
    )
    wts_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), wts)
    return fbk, cmd, wts_b


def _fixture(fixtures_dir=None):
    """The golden standing quat-MPC fixture (``quat_mpc_test.json``, the
    reference's TestAltroQuatMpc.cpp problem, N=20, h=0.01) in f64 numpy:
    x_ref, u_ref, Qd, Rd, the friction pyramid Cu/cb, and the golden
    optimum (us (20,12), xs (21,13))."""
    import json
    import pathlib

    if fixtures_dir is None:
        fixtures_dir = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures"
    with open(pathlib.Path(fixtures_dir) / "quat_mpc_test.json") as f:
        fix = json.load(f)

    # friction pyramid (TestAltroQuatMpc.cpp:114-124): μ=0.6, fz_max=200
    mu, fz_max = 0.6, 200.0
    Cu = np.zeros((24, 12))
    cb = np.zeros(24)
    for i in range(4):
        Cu[6 * i + 0, 3 * i + 0] = 1
        Cu[6 * i + 0, 3 * i + 2] = -mu
        Cu[6 * i + 1, 3 * i + 0] = -1
        Cu[6 * i + 1, 3 * i + 2] = -mu
        Cu[6 * i + 2, 3 * i + 1] = 1
        Cu[6 * i + 2, 3 * i + 2] = -mu
        Cu[6 * i + 3, 3 * i + 1] = -1
        Cu[6 * i + 3, 3 * i + 2] = -mu
        Cu[6 * i + 4, 3 * i + 2] = 1
        cb[6 * i + 4] = -fz_max
        Cu[6 * i + 5, 3 * i + 2] = -1

    return dict(
        x_ref=np.asarray(fix["reference_state"], dtype=np.float64),
        u_ref=np.asarray(fix["reference_input"], dtype=np.float64),
        Qd=np.array([1.0, 1, 1, 0, 0, 0, 0, 2, 2, 2, 1, 1, 1]),
        Rd=np.full((12,), 1e-6),
        Cu=Cu,
        cb=cb,
        gold_us=np.asarray(fix["input_trajectory"], dtype=np.float64),
        gold_xs=np.asarray(fix["state_trajectory"], dtype=np.float64),
    )


def fixture_fleet_problem(batch: int, dtype, fixtures_dir=None):
    """The golden standing fixture as a batch-B `FleetProblem` for the fleet
    solver, plus its f64 golden optimum (us, xs) — the oracle for the
    on-device f32 quality guard (it fails if the accelerator's f32 path
    degrades).

    Returns (prob, gold_us (20,12) f64 np, gold_xs (21,13) f64 np).
    """
    import jax.numpy as jnp

    from quaternion_mpc_tpu.models import srb
    from quaternion_mpc_tpu.solver.fleet import FleetProblem

    fx = _fixture(fixtures_dir)
    bl = lambda a: jnp.broadcast_to(
        jnp.asarray(a, dtype)[..., None], a.shape + (batch,)
    )
    params = srb.params_to_fleet(srb.go1_params(dtype=dtype))
    prob = FleetProblem(
        x0=bl(fx["x_ref"][0]),
        x_ref=bl(fx["x_ref"]),
        u_ref=bl(fx["u_ref"]),
        Qd=bl(fx["Qd"]),
        Rd=bl(fx["Rd"]),
        w=jnp.ones((1,), dtype),
        Cu=bl(fx["Cu"]),
        cb=bl(fx["cb"]),
        h=jnp.asarray(0.01, dtype),
        params=params,
        us_init=bl(fx["u_ref"][:20]),
    )
    return prob, fx["gold_us"], fx["gold_xs"]


def fixture_problem(dtype, fixtures_dir=None):
    """The golden standing fixture as one robot's `TrajOptProblem` for the
    per-robot AL-iLQR solver (`solver.make_solver`, which
    `quat_mpc.make_controller` runs), plus its f64 golden optimum."""
    import jax.numpy as jnp

    from quaternion_mpc_tpu.models import srb
    from quaternion_mpc_tpu.solver import CostSpec, TrajOptProblem

    fx = _fixture(fixtures_dir)
    a = lambda v: jnp.asarray(v, dtype)
    prob = TrajOptProblem(
        x0=a(fx["x_ref"][0]),
        cost=CostSpec(Qd=a(fx["Qd"]), Rd=a(fx["Rd"]), w=a(1.0),
                      x_ref=a(fx["x_ref"]), u_ref=a(fx["u_ref"])),
        Cu=a(fx["Cu"]),
        cb=a(fx["cb"]),
        h=a(0.01),
        params=srb.go1_params(dtype=dtype),
        us_init=a(fx["u_ref"][:20]),
    )
    return prob, fx["gold_us"], fx["gold_xs"]


def fixture_gold_cost(gold_us, gold_xs, fixtures_dir=None) -> float:
    """Raw f64 objective of the golden fixture trajectory, computed in numpy
    on the host, independent of the solver code. Matches the solvers'
    final-cost convention: tracking + geodesic quat cost, no AL terms."""
    fx = _fixture(fixtures_dir)
    x_ref, u_ref, Qd, Rd = fx["x_ref"], fx["u_ref"], fx["Qd"], fx["Rd"]
    w = 1.0
    xs = np.asarray(gold_xs, np.float64)
    us = np.asarray(gold_us, np.float64)
    total = 0.0
    for k in range(xs.shape[0]):
        dx = xs[k] - x_ref[k]
        total += 0.5 * float(dx @ (Qd * dx))
        total += w * (1.0 - abs(float(xs[k, 3:7] @ x_ref[k, 3:7])))
        if k < us.shape[0]:
            du = us[k] - u_ref[k]
            total += 0.5 * float(du @ (Rd * du))
    return total


def fixture_f32_guard(cost, u0, gold_us, gold_xs) -> dict:
    """The f32 quality guard: a solution of the golden fixture against the
    golden f64 optimum. ``cost`` is the solved objective (any shape, one per
    scenario) and ``u0`` the first input (..., nu). ``ok`` when every cost
    is finite and within rtol 5e-3 of the golden objective, and u(0) is
    within 0.5 N of the golden first input."""
    cost = np.asarray(cost, np.float64)
    gold_cost = fixture_gold_cost(gold_us, gold_xs)
    cost_rel = float(np.max(np.abs(cost - gold_cost))) / abs(gold_cost)
    u0_err = float(np.max(np.abs(np.asarray(u0, np.float64) - gold_us[0])))
    ok = bool(np.all(np.isfinite(cost)) and cost_rel <= 5e-3 and u0_err <= 0.5)
    return {"cost_rel": cost_rel, "u0_err": u0_err, "ok": ok}
