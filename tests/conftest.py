"""Test harness config: CPU backend with 8 virtual devices, f64 enabled.

Fixture-fidelity tests compare against Eigen-double golden trajectories from
the reference repo (SURVEY.md §4), so tests run in f64 on CPU. Multi-chip
sharding logic is exercised on a virtual 8-device CPU mesh
(xla_force_host_platform_device_count), per SURVEY.md §4 item (d).
"""

import os

# CPU unless JAX_PLATFORMS says otherwise: the f64 fixture tests and the
# virtual 8-device mesh tests run there. Tests marked `gpu` need a card and
# run with JAX_PLATFORMS=cuda (README); on the CPU they skip.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402

import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES


# ---------------------------------------------------------------------------
# fast/slow tiers. `pytest -m fast` is the <2-minute correctness core
# (fixtures, units, kinematics, estimation, sharding guards); everything
# else — closed-loop sims, threaded runtime, multiprocess — is `slow`.
# ---------------------------------------------------------------------------

_FAST_FILES = {
    "test_lie.py",
    "test_kin.py",
    "test_gait.py",
    "test_srb.py",
    "test_classic.py",
    "test_solver_fixtures.py",
    "test_f32_quality.py",
    "test_estimation.py",
    "test_native.py",
    "test_hardware_layer.py",
    "test_visualize.py",
    "test_aux_subsystems.py",
    "test_chip_smoke.py",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "fast: correctness core, whole tier runs < 2 min")
    config.addinivalue_line(
        "markers", "slow: closed-loop / threaded / multiprocess tiers")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (run with JAX_PLATFORMS=cuda); skips on CPU")


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = pathlib.Path(str(item.fspath)).name
        item.add_marker(
            pytest.mark.fast if name in _FAST_FILES else pytest.mark.slow
        )
