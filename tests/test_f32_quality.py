"""f32 solver quality guard: the f32 solves of the golden standing fixture
(fleet solver on both backends, per-robot AL-iLQR) must land on the f64
golden optimum (cost and u(0)) within a stated tolerance. This is the CPU
companion of the on-device checks in bench.py and chip_smoke.py, which
catch silent reduced-precision arithmetic (TF32 products on a GPU)."""

import jax
import jax.numpy as jnp
import numpy as np

from quaternion_mpc_tpu import examples
from quaternion_mpc_tpu.control import quat_mpc
from quaternion_mpc_tpu.solver import SolverOptions, make_solver
from quaternion_mpc_tpu.solver import fleet as fl


def _gold_cost(prob64, gold_us, gold_xs):
    spec = quat_mpc._fleet_spec()
    us = jnp.asarray(gold_us, jnp.float64)[..., None]
    xs = jnp.asarray(gold_xs, jnp.float64)[..., None]
    lam = jnp.zeros((20, 24, 1), jnp.float64)
    return float(
        fl.total_cost(spec, xs, us, prob64, lam, jnp.asarray(1e-30, jnp.float64))[0]
    )


def test_f32_fleet_matches_f64_fixture_optimum():
    B = 8
    prob32, gold_us, gold_xs = examples.fixture_fleet_problem(B, jnp.float32)
    prob64, _, _ = examples.fixture_fleet_problem(1, jnp.float64)
    spec = quat_mpc._fleet_spec()
    solver = jax.jit(fl.make_fleet_solver(spec, SolverOptions()))
    sol = solver(prob32)

    gold_cost = _gold_cost(prob64, gold_us, gold_xs)
    f32_cost = np.asarray(sol.cost, np.float64)
    # every lane in the batch must hit the optimum: cost within 0.5% of the
    # golden objective, first input within 0.5 N of the golden GRFs
    assert np.all(np.isfinite(f32_cost))
    np.testing.assert_allclose(f32_cost, gold_cost, rtol=5e-3)
    u0 = np.asarray(sol.us[0]).T  # (B, 12)
    np.testing.assert_allclose(
        u0, np.broadcast_to(gold_us[0], u0.shape), atol=0.5
    )


def test_f32_assoc_backend_matches_f64_fixture_optimum():
    """Same guard for the ASSOCIATIVE-SCAN backend — the single-robot
    latency path the bench's N=10/N=20 cold rows run (B=1, f32 on the
    device): its different op order (log-depth combines, one stacked
    Gauss-Jordan per combine) must also land on the golden optimum."""
    prob32, gold_us, gold_xs = examples.fixture_fleet_problem(1, jnp.float32)
    prob64, _, _ = examples.fixture_fleet_problem(1, jnp.float64)
    spec = quat_mpc._fleet_spec()
    solver = jax.jit(fl.make_fleet_solver(spec, SolverOptions(), backend="assoc"))
    sol = solver(prob32)

    gold_cost = _gold_cost(prob64, gold_us, gold_xs)
    f32_cost = np.asarray(sol.cost, np.float64)
    assert np.all(np.isfinite(f32_cost))
    np.testing.assert_allclose(f32_cost, gold_cost, rtol=5e-3)
    u0 = np.asarray(sol.us[0]).T
    np.testing.assert_allclose(
        u0, np.broadcast_to(gold_us[0], u0.shape), atol=0.5
    )


def test_f32_per_robot_solver_matches_f64_fixture_optimum():
    """Same guard for the per-robot AL-iLQR solver that
    `quat_mpc.make_controller` runs (the served runtime's controller): its
    Riccati recursion is written with matrix products."""
    prob32, gold_us, gold_xs = examples.fixture_problem(jnp.float32)
    sol = jax.jit(make_solver(quat_mpc.MODEL_SPEC, SolverOptions()))(prob32)
    guard = examples.fixture_f32_guard(sol.stats.cost, sol.us[0], gold_us, gold_xs)
    assert guard["ok"], guard


def test_matrix_products_run_at_full_f32():
    """Importing the package pins every matrix product at HIGHEST precision,
    so no f32 `@` on a control path can run in TF32 on a GPU: every
    dot_general the single-robot controller traces carries it."""
    assert jax.config.jax_default_matmul_precision == "highest"
    fbk, cmd, wts = jax.tree.map(
        lambda a: a[0], examples.standing_batch(1, 4, np.float32)
    )
    hlo = jax.jit(quat_mpc.make_controller(4)).lower(fbk, cmd, wts).as_text()
    dots = [ln for ln in hlo.splitlines() if "stablehlo.dot_general" in ln]
    assert dots and all("HIGHEST" in ln for ln in dots)
