"""Aux subsystems: sim terrain worlds, checkpoint/resume, telemetry, CLI."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quaternion_mpc_tpu.sim import terrain as world
from quaternion_mpc_tpu.utils import checkpoint as ckpt
from quaternion_mpc_tpu.utils import telemetry


def test_terrain_worlds_height_and_normal():
    flat = world.make_terrain("flat")
    slope = world.make_terrain("slope", slope_grade=0.25)
    stairs = world.make_terrain("stairs", stair_rise=0.17, stair_run=0.30)
    space = world.make_terrain("space")

    pts = jnp.asarray([[-0.5, 0.0], [0.15, 0.1], [0.95, -0.2]], jnp.float32)
    np.testing.assert_allclose(np.asarray(world.height(flat, pts)), 0.0)
    np.testing.assert_allclose(
        np.asarray(world.height(slope, pts)), [0.0, 0.0375, 0.2375], atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(world.height(stairs, pts)), [0.0, 0.0, 0.51], atol=1e-6
    )
    assert float(space.gravity) == 0.0

    n = world.normal(slope, pts)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(n), axis=-1), 1.0, atol=1e-6)
    assert float(n[1, 0]) < 0.0  # slope normal leans back toward -x
    np.testing.assert_allclose(np.asarray(world.normal(stairs, pts))[:, 2], 1.0)


def test_terrain_snap_and_contact():
    stairs = world.make_terrain("stairs")
    # mid-tread target: plain projection onto the second step's top
    p = jnp.asarray([0.75, 0.0, 0.9], jnp.float32)
    snapped = world.snap_to_ground(stairs, p)
    np.testing.assert_allclose(float(snapped[0]), 0.75, atol=1e-6)
    np.testing.assert_allclose(float(snapped[2]), 0.34, atol=1e-6)
    # near-edge target (5 cm past the 0.60 riser): foothold adaptation
    # pulls it BACK to the lower tread, never within the edge margin
    edge = world.snap_to_ground(stairs, jnp.asarray([0.65, 0.0, 0.9], jnp.float32))
    np.testing.assert_allclose(float(edge[0]), 0.54, atol=1e-6)
    np.testing.assert_allclose(float(edge[2]), 0.17, atol=1e-6)
    prob_on = world.contact_probability(stairs, snapped, jnp.asarray(50.0))
    prob_air = world.contact_probability(stairs, p, jnp.asarray(50.0))
    assert float(prob_on) > 0.99
    assert float(prob_air) == 0.0


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "plant": {"pos": jnp.arange(3.0), "quat": jnp.asarray([1.0, 0, 0, 0])},
        "count": jnp.asarray(7, jnp.int32),
    }
    path = ckpt.save(tmp_path / "ck", tree, metadata={"step": 42})
    assert path.exists()
    like = jax.tree.map(jnp.zeros_like, tree)
    back = ckpt.restore(tmp_path / "ck", like=like)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    assert ckpt.metadata(tmp_path / "ck")["step"] == 42
    # restore without `like` uses the pickled treedef
    back2 = ckpt.restore(tmp_path / "ck")
    np.testing.assert_allclose(np.asarray(back2["plant"]["pos"]), [0, 1, 2])


def test_telemetry_channels(tmp_path):
    log = tmp_path / "telemetry.jsonl"
    t = telemetry.TelemetryLogger(str(log))
    t.publish_state(
        pos=[0, 0, 0.3], quat=[1, 0, 0, 0], vel=[0, 0, 0],
        pos_d=[0, 0, 0.3],
        grf=np.ones((4, 3)), contacts=[1, 1, 1, 1],
        mpc_time_s=0.002, fleet_metrics={"alive": 8.0},
        n_solves=8,
    )
    t.publish_state(mpc_time_s=0.004, n_solves=8)
    stats = t.summary()
    t.close()
    assert stats["p50_ms"] is not None and stats["p99_ms"] >= stats["p50_ms"]
    channels = [json.loads(l)["ch"] for l in log.read_text().splitlines()]
    for ch in ("odom", "odom_d", "mpc_grf", "mpc_time", "fleet"):
        assert ch in channels, ch


def test_cli_bench_solver_smoke(capsys):
    from quaternion_mpc_tpu import cli

    rc = cli.main(["bench_solver", "--batch", "8", "--iters", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["solves_per_sec"] > 0
    assert np.isfinite(out["mean_cost"])


def test_cli_run_standing_smoke(capsys):
    from quaternion_mpc_tpu import cli

    rc = cli.main(["run_standing", "--batch", "2", "--steps", "5"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["alive_frac"] == 1.0


def test_cli_run_scenario_falling_cat(capsys):
    from quaternion_mpc_tpu import cli

    rc = cli.main(["run_scenario", "--name", "falling_cat", "--f64"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["attitude_error"] < 1e-3
    assert out["max_input"] <= 8.0 + 1e-4


def test_profiling_timed_and_floor():
    import jax.numpy as jnp

    from quaternion_mpc_tpu.utils import profiling

    floor = profiling.measure_dispatch_floor(iters=3)
    assert floor >= 0.0
    f = jax.jit(lambda x: jnp.sum(x * 2))
    stats = profiling.timed(f, jnp.ones(64), iters=3)
    assert stats["raw_p50_s"] >= stats["p50_s"] >= 0.0


@pytest.mark.parametrize("env_dir", [None, "outside"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache directory the
    program configures; otherwise the cache is the fixed <repo>/.jax_cache."""
    from quaternion_mpc_tpu.utils import compile_cache

    repo_cache = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(repo_cache)
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
