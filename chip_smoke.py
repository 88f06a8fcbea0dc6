"""On-card smoke test of the quaternion-MPC system.

    python chip_smoke.py               # every one-GPU phase, in one process
    python chip_smoke.py --multi-card  # only the sharded fleet, four GPUs

Drives the main paths once through the entry points a user calls (the CLI,
the fleet solver, the control steps, the served runtime), at the Go1
deployment sizes, and checks each against the repository's references: the
golden C++ fixtures (the f32 guard and the f64 match), the same control step
in f64 on the CPU, and the same fleet on one card. All phases run in this
one process, which is the only one that opens the card. A failed check ends
the run with a nonzero exit code; the last line of stdout, one JSON object
naming the device, is printed only when every phase passed.

Each phase is a function whose sizes default to the deployment sizes; the
CPU tests call them at tiny sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# bench.py's estimated-fleet sensor noise (IMU specific force, gyro,
# leg-odometry velocity, FK foot position), one std per channel
NOISE = dict(noise_acc=0.2, noise_gyro=0.02, noise_foot_vel=0.02,
             noise_foot_pos=0.003)

# Noise-free estimated loop, f32 on the device vs f64 on the CPU: largest
# |difference| of torso position [m], velocity [m/s], attitude quaternion,
# KF mean and KF covariance. Measured with f32 on the CPU (B=64, N=10):
# after the first tick every one is below 5e-7, and the covariance stays
# below 6e-6 over five ticks; from the second tick on, the f32 solver's
# line-search decisions part from f64's and the torso state differs by up
# to 1.3e-2. TF32 products (about three decimal digits) in the KF break the
# first two bounds: on an H100 at default precision the tick-1 KF covariance
# was off by 8e-4 (the package pins full f32, quaternion_mpc_tpu/__init__.py).
EST_TOL_TICK1 = 1e-5
EST_TOL_COV = 1e-4
EST_TOL_STATE = 5e-2


def _log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def _p50(fn, iters: int) -> float:
    import jax

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def device_gate(n_devices: int = 1):
    """Phase 1: refuse anything but GPUs; print the card, flags and cache."""
    import jax

    from quaternion_mpc_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found {devs[0].platform} "
            f"({devs[0].device_kind})"
        )
    if len(devs) < n_devices:
        raise SystemExit(f"need {n_devices} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    _log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    _log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    _log(f"compile cache: {enable_compile_cache()}")
    return devs[0]


def dispatch_honesty(n: int = 4096, target_s: float = 0.1) -> dict:
    """Phase 2: time one ~target_s jitted computation twice, ended by
    `block_until_ready` and by pulling its value to the host. If the first
    returned early, every timing in the repository would be wrong."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(x, k):
        y = jax.lax.fori_loop(0, k, lambda i, y: jnp.tanh(y @ x), x)
        return jnp.sum(y)

    x = jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float32) / math.sqrt(n)
    one = jnp.asarray(1, jnp.int32)
    float(chain(x, one))  # compile
    t1 = min(_pull_time(chain, x, one) for _ in range(3))
    k = jnp.asarray(max(1, round(target_s / max(t1, 1e-6))), jnp.int32)
    float(chain(x, k))
    t_block = _p50(lambda: chain(x, k), 5)
    t_pull = float(np.median([_pull_time(chain, x, k) for _ in range(5)]))
    _log(f"dispatch: {int(k)} chained {n}x{n} products: block_until_ready "
         f"{t_block * 1e3:.3f} ms, value pull {t_pull * 1e3:.3f} ms")
    if t_block < 0.5 * t_pull:
        raise AssertionError(
            f"block_until_ready returned before the work ended "
            f"({t_block * 1e3:.3f} ms vs {t_pull * 1e3:.3f} ms by value pull)"
        )
    return {"block_ms": t_block * 1e3, "pull_ms": t_pull * 1e3, "k": int(k)}


def _pull_time(fn, *args) -> float:
    t0 = time.perf_counter()
    float(fn(*args))
    return time.perf_counter() - t0


def run_cli(argv) -> dict:
    """`cli.main(argv)` in this process; returns its one-line JSON summary."""
    from quaternion_mpc_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} returned {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    _log(f"cli {' '.join(argv)} -> {json.dumps(out)}")
    return out


def _finite(out: dict, key: str) -> None:
    if not math.isfinite(out[key]):
        raise AssertionError(f"{key} is not finite: {out[key]}")


def cli_fleet(solver_batch: int = 16384, batch: int = 4096, steps: int = 50,
              horizon: int = 10) -> None:
    """Phase 3: the quat-MPC fleet through the CLI — the raw solver at the
    top of the benchmark sweep, then the standing and trotting fleets
    (BASELINE config 5's 4096 Go1 scenarios) closed-loop."""
    h = ["--horizon", str(horizon)]
    out = run_cli(["bench_solver", "--batch", str(solver_batch), *h])
    _finite(out, "mean_cost")
    for argv in (
        ["run_standing", "--batch", str(batch), "--steps", str(steps), *h],
        ["run_trot", "--batch", str(batch), "--steps", str(steps), *h,
         "--velx", "0.4"],
    ):
        out = run_cli(argv)
        if out["alive_frac"] != 1.0:
            raise AssertionError(f"{argv[0]}: alive_frac {out['alive_frac']}")
        _finite(out, "mpc_cost_final")


def convex_fleet(batch: int = 4096, horizon: int = 10) -> None:
    """Phase 4: the Euler convex-MPC baseline through the CLI."""
    out = run_cli(["bench_solver", "--batch", str(batch), "--horizon",
                   str(horizon), "--config", "gazebo_go1_convex_mpc"])
    _finite(out, "mean_cost")


def _estimated_fleet(batch, horizon, ticks, dtype, noise, seed=0):
    """`ticks` ticks of the estimated fleet step (BasicKF in the loop) on
    the default device; returns the carry after each tick and the last
    tick's metrics."""
    import jax
    import jax.numpy as jnp

    from quaternion_mpc_tpu.control import quat_mpc
    from quaternion_mpc_tpu.runtime import step as rt
    from quaternion_mpc_tpu.solver import SolverOptions
    from quaternion_mpc_tpu.utils import config as cfg_mod

    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    carry1, sp1 = rt.init_estimated_walking_scenario(wts, dtype=dtype, kf_type=1)
    joy1 = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.3, dtype))
    tile = lambda t: jax.tree.map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape), t
    )
    carry, sp, joy = tile(carry1), tile(sp1), tile(joy1)
    vel0 = 0.05 * np.random.default_rng(seed).standard_normal((batch, 3))
    carry = carry._replace(
        plant=carry.plant._replace(vel=jnp.asarray(vel0, dtype)),
        key=jax.random.split(jax.random.PRNGKey(seed), batch),
    )
    step = jax.jit(rt.make_fleet_estimated_step(
        horizon=horizon,
        opts=SolverOptions(al_iterations=2, ilqr_iterations=5, max_linesearch=8),
        kf_type=1, **(NOISE if noise else {}),
    ))
    carries, metrics = [], None
    for _ in range(ticks):
        carry, metrics = step(carry, sp, joy)
        carries.append(carry)
    jax.block_until_ready(carry)
    return carries, metrics


def estimator_loop(batch: int = 4096, ticks: int = 10, horizon: int = 10,
                   ref_batch: int = 64, ref_ticks: int = 5) -> dict:
    """Phase 5: the estimator in the loop (`make_fleet_estimated_step`,
    BasicKF, bench.py's sensor noise); then the noise-free loop on the
    device in f32 against the same step on the CPU in f64."""
    import jax
    import jax.numpy as jnp

    _, m = _estimated_fleet(batch, horizon, ticks, jnp.float32, noise=True)
    alive = float(np.sum(np.asarray(m.alive)))
    est_err = float(np.mean(np.asarray(m.est_err)))
    _log(f"estimated fleet B={batch}, {ticks} noisy ticks: alive "
         f"{alive:.0f}/{batch}, mean est_err {est_err:.4f} m")
    if alive != batch or not est_err < 0.2:
        raise AssertionError(f"estimated fleet: alive {alive}/{batch}, "
                             f"mean est_err {est_err} m (gate 0.2 m)")

    dev, _ = _estimated_fleet(ref_batch, horizon, ref_ticks, jnp.float32,
                              noise=False)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        ref, _ = _estimated_fleet(ref_batch, horizon, ref_ticks, jnp.float64,
                                  noise=False)
        fields = lambda c: {
            "pos": c.plant.pos, "vel": c.plant.vel, "quat": c.plant.quat,
            "kf_x": c.est.x, "kf_P": c.est.P,
        }
        errs = [
            {k: float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b))))
             for (k, a), b in zip(fields(d).items(), fields(r).values())}
            for d, r in zip(dev, ref)
        ]
    for t, e in enumerate(errs, 1):
        _log(f"estimated loop B={ref_batch} tick {t}, f32 "
             f"{jax.devices()[0].platform} vs f64 cpu: "
             + ", ".join(f"{k} {v:.2e}" for k, v in e.items()))
    bad = [k for k, v in errs[0].items() if not v <= EST_TOL_TICK1]
    bad += [f"kf_P@{t}" for t, e in enumerate(errs, 1)
            if not e["kf_P"] <= EST_TOL_COV]
    bad += [f"{k}@{t}" for t, e in enumerate(errs, 1)
            for k in ("pos", "vel", "quat", "kf_x") if not e[k] <= EST_TOL_STATE]
    if bad:
        raise AssertionError(
            f"estimated loop f32 vs f64 past tolerance (tick 1 "
            f"{EST_TOL_TICK1:g}, covariance {EST_TOL_COV:g}, state "
            f"{EST_TOL_STATE:g}): {bad}"
        )
    return {"alive": alive, "est_err": est_err, **errs[-1]}


def fixture_checks(batch: int = 4096) -> dict:
    """Phase 6: the golden standing fixture (TestAltroQuatMpc.cpp) on the
    device. f32 guard: the fleet solver's XLA sweep at `batch`, its
    associative scan at B=1, and the per-robot AL-iLQR solver that
    `quat_mpc.make_controller` (the served runtime's controller) runs, at
    B=1, land on the golden optimum (cost rtol 5e-3, u(0) within 0.5 N).
    f64: the XLA sweep at `batch` matches the golden trajectories (inputs
    atol 1e-4, states atol 1e-5), as tests/test_fleet_solver.py does."""
    import jax
    import jax.numpy as jnp

    from quaternion_mpc_tpu import examples
    from quaternion_mpc_tpu.control import quat_mpc
    from quaternion_mpc_tpu.solver import SolverOptions, make_solver
    from quaternion_mpc_tpu.solver import fleet as fl

    spec = quat_mpc._fleet_spec()
    out = {}
    for b, backend in ((batch, "xla"), (1, "assoc"), (1, "al_ilqr")):
        if backend == "al_ilqr":
            prob, gold_us, gold_xs = examples.fixture_problem(jnp.float32)
            sol = jax.jit(make_solver(quat_mpc.MODEL_SPEC, SolverOptions()))(prob)
            cost, u0 = sol.stats.cost, sol.us[0]
        else:
            prob, gold_us, gold_xs = examples.fixture_fleet_problem(b, jnp.float32)
            sol = jax.jit(fl.make_fleet_solver(spec, SolverOptions(),
                                               backend=backend))(prob)
            cost, u0 = sol.cost, sol.us[0].T
        guard = examples.fixture_f32_guard(cost, u0, gold_us, gold_xs)
        _log(f"f32 guard {backend} B={b}: cost rel err {guard['cost_rel']:.2e} "
             f"(tol 5e-3), u0 err {guard['u0_err']:.2e} N (tol 0.5)")
        if not guard["ok"]:
            raise AssertionError(f"f32 guard failed on {backend} B={b}: {guard}")
        out[f"f32_{backend}_cost_rel"] = guard["cost_rel"]
        out[f"f32_{backend}_u0_err"] = guard["u0_err"]

    with jax.enable_x64(True):
        prob, gold_us, gold_xs = examples.fixture_fleet_problem(batch, jnp.float64)
        sol = jax.jit(fl.make_fleet_solver(spec, SolverOptions(), backend="xla"))(prob)
        us = np.moveaxis(np.asarray(sol.us), -1, 0)  # (B, N, nu)
        xs = np.moveaxis(np.asarray(sol.xs), -1, 0)
    u_err = float(np.max(np.abs(us - gold_us)))
    x_err = float(np.max(np.abs(xs - gold_xs)))
    _log(f"f64 fixture xla B={batch} on {jax.devices()[0].platform}: input err "
         f"{u_err:.2e} (tol 1e-4), state err {x_err:.2e} (tol 1e-5)")
    if not (u_err <= 1e-4 and x_err <= 1e-5):
        raise AssertionError(f"f64 fixture mismatch: u {u_err}, x {x_err}")
    out.update(f64_u_err=u_err, f64_x_err=x_err)
    return out


def single_robot(horizon: int = 20, ticks: int = 50) -> dict:
    """Phase 7: one robot at the online config (N=20, h=10 ms), the 200 Hz
    loop compiled as one `ticks`-tick scan: cold 2 AL x 5 iLQR and warm RTI
    1 AL x 3, on both Riccati backends. ms/tick is printed, not gated."""
    import jax
    import jax.numpy as jnp

    import bench
    from quaternion_mpc_tpu.solver import SolverOptions

    rows = {}
    for label, opts, warm in (
        ("cold 2ALx5", SolverOptions(al_iterations=2, ilqr_iterations=5), False),
        ("warm RTI 1ALx3", SolverOptions(al_iterations=1, ilqr_iterations=3,
                                         penalty_initial=10.0), True),
    ):
        for backend in ("assoc", "xla"):
            fn, args = bench.scanned_loop(horizon, opts, warm, False, backend,
                                          ticks, jnp.float32)
            args = jax.device_put(args)
            out, cost = jax.block_until_ready(fn(*args))  # compile + warm
            if not (np.isfinite(float(out)) and np.isfinite(float(cost))):
                raise AssertionError(f"{label} {backend}: non-finite cost")
            ms = _p50(lambda: fn(*args), 5) / ticks * 1e3
            rows[f"{label} {backend}"] = ms
            _log(f"single robot N={horizon} {label} [{backend}]: {ms:.3f} "
                 f"ms/tick over a {ticks}-tick scan, last cost {float(cost):.5f}")
    return rows


def served_runtime(duration: float = 2.0) -> dict:
    """Phase 8: the threaded runtime (native RateLoop, seqlock buses, UDP
    sim peer) standing for `duration` s through the CLI."""
    out = run_cli(["run_hardware", "--duration", str(duration)])
    if not out["upright"]:
        raise AssertionError("served runtime: robot fell")
    _finite(out, "mean_mpc_cost")
    _log(f"served runtime findings: mpc_rate_used {out['mpc_rate_used']}, "
         f"tick_wall_ms {out['tick_wall_ms']}, mpc_overruns {out['mpc_overruns']}")
    return out


def _walking_fleet_rate(devices, batch: int, horizon: int) -> float:
    """Solves/s of the warm walking fleet (1 AL x 3 iLQR, 8 alphas, f32)
    sharded over `devices`, ended by block_until_ready."""
    import jax
    import jax.numpy as jnp

    from quaternion_mpc_tpu.control import quat_mpc
    from quaternion_mpc_tpu.parallel import mesh as mesh_mod
    from quaternion_mpc_tpu.runtime import step as rt
    from quaternion_mpc_tpu.solver import SolverOptions
    from quaternion_mpc_tpu.utils import config as cfg_mod

    dtype = jnp.float32
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype)
    carry1, sp1 = rt.init_walking_scenario(
        wts, dtype=dtype, warm_start=True, horizon=horizon
    )
    joy1 = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(0.3, dtype))
    m = mesh_mod.scenario_mesh(devices)
    carry, sp, joy = (
        mesh_mod.shard_batch(
            jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), t), m
        )
        for t in (carry1, sp1, joy1)
    )
    step = jax.jit(mesh_mod.fleet_shard(rt.make_fleet_walking_step(
        horizon=horizon,
        opts=SolverOptions(al_iterations=1, ilqr_iterations=3,
                           penalty_initial=10.0, max_linesearch=8),
        warm_start=True,
    ), m))
    for _ in range(3):  # settle into the warm regime
        carry, metrics = step(carry, sp, joy)
    jax.block_until_ready(carry)
    if float(metrics.alive) != batch:
        raise AssertionError(f"walking fleet lost scenarios on {len(devices)} devices")
    return batch / _p50(lambda: step(carry, sp, joy), 10)


def multi_card(n_devices: int = 4, per_device: int = 64, horizon: int = 10,
               n_ticks: int = 50, rate_per_device: int = 4096) -> dict:
    """Phase 9 (--multi-card): `__graft_entry__.dryrun_multichip` on
    n_devices cards — the sharded standing fleet, the walking fleet sharded
    against the same fleet on one card (f64, n_ticks ticks, gate 1e-6) and
    the sharded estimated fleet — then the f32 sharded walking fleet's rate
    at rate_per_device scenarios per card against one card, printed."""
    import jax

    from __graft_entry__ import dryrun_multichip

    devices = jax.devices()[:n_devices]
    out = dryrun_multichip(n_devices, devices=devices, per_device=per_device,
                           horizon=horizon, n_ticks=n_ticks)
    _log(f"walking fleet f64, {n_devices}x{per_device} scenarios, {n_ticks} "
         f"ticks: sharded vs one {devices[0].platform} device pos "
         f"{out['parity_pos_err']:.2e}, quat {out['parity_quat_err']:.2e} "
         f"(gate 1e-6)")
    sps_n = _walking_fleet_rate(devices, rate_per_device * n_devices, horizon)
    sps_1 = _walking_fleet_rate(devices[:1], rate_per_device, horizon)
    eff = sps_n / (n_devices * sps_1)
    _log(f"walking fleet f32: {n_devices}x{rate_per_device} sharded "
         f"{sps_n:,.1f} solves/s; 1x{rate_per_device} {sps_1:,.1f} solves/s; "
         f"scaling efficiency {eff:.4f}")
    return {**out, "solves_per_sec_n": sps_n, "solves_per_sec_1": sps_1,
            "efficiency": eff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-card", action="store_true",
                    help="run only the sharded fleet on four GPUs against "
                         "the same fleet on one")
    args = ap.parse_args(argv)

    import jax

    dev = device_gate(4 if args.multi_card else 1)
    phases = [multi_card] if args.multi_card else [
        dispatch_honesty, cli_fleet, convex_fleet, estimator_loop,
        fixture_checks, single_robot, served_runtime,
    ]
    t_start = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        _log(f"{phase.__name__} ok in {time.perf_counter() - t0:.1f} s")
    _log(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
