"""chip_smoke.py on the CPU: its device gate refuses the CPU backend, and
every phase runs at tiny sizes (B=2, N=4) against its references. The
served-runtime phase only means something on a card and skips here."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def gpu():
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {platform}")


@pytest.mark.parametrize("argv", [[], ["--multi-card"]])
def test_device_gate_refuses_cpu(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "chip_smoke.py", *argv], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    assert "needs a GPU" in run.stderr


def test_dispatch_honesty():
    out = cs.dispatch_honesty(n=64, target_s=0.01)
    assert out["k"] >= 1 and out["block_ms"] > 0.0 and out["pull_ms"] > 0.0


def test_cli_fleet():
    cs.cli_fleet(solver_batch=2, batch=2, steps=3, horizon=4)


def test_convex_fleet():
    cs.convex_fleet(batch=2, horizon=4)


def test_estimator_loop():
    out = cs.estimator_loop(batch=2, ticks=3, horizon=4, ref_batch=2, ref_ticks=5)
    assert out["alive"] == 2.0 and out["est_err"] < 0.2


def test_fixture_checks():
    out = cs.fixture_checks(batch=2)
    assert out["f64_u_err"] <= 1e-4 and out["f64_x_err"] <= 1e-5
    assert {"f32_xla_u0_err", "f32_assoc_u0_err", "f32_al_ilqr_u0_err"} <= set(out)


def test_single_robot():
    rows = cs.single_robot(horizon=4, ticks=3)
    assert len(rows) == 4 and all(ms > 0.0 for ms in rows.values())


@pytest.mark.gpu
def test_served_runtime(gpu):
    out = cs.served_runtime(duration=2.0)
    assert out["upright"]


def test_multi_card_on_virtual_devices():
    out = cs.multi_card(n_devices=4, per_device=2, horizon=4, n_ticks=3,
                        rate_per_device=2)
    assert out["parity_pos_err"] < 1e-6 and out["parity_quat_err"] < 1e-6
    assert out["walking_alive"] == 8.0 and out["efficiency"] > 0.0
    assert out["estimated_alive"] == 8.0 and out["devices"] == 4
