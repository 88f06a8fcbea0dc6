"""Command-line entry points (SURVEY.md §7.9 — the launch-file layer).

The reference's user surface is `roslaunch legged_ctrl
{gazebo,hardware}_go1_{convex_mpc,quat_mpc}.launch` + a joystick
(``README.md:72-79``). The equivalents here run the same controllers
closed-loop against the in-framework plant, batched over a scenario fleet:

    python -m quaternion_mpc_tpu.cli run_standing --batch 64 --steps 200
    python -m quaternion_mpc_tpu.cli run_trot --velx 0.4 --seconds 4
    python -m quaternion_mpc_tpu.cli run_fleet --batch 4096 --steps 100 \
        --checkpoint /tmp/fleet.ckpt
    python -m quaternion_mpc_tpu.cli bench_solver --batch 4096

Each command prints a one-line JSON summary on stdout (details on stderr)
and optionally streams LeggedLogger-style telemetry with --log.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=64, help="fleet size")
    p.add_argument("--steps", type=int, default=100, help="control ticks")
    p.add_argument("--horizon", type=int, default=10, help="MPC horizon N")
    p.add_argument("--config", default="gazebo_go1_quat_mpc",
                   help="config preset name (utils.config.presets)")
    p.add_argument("--log", default=None, help="telemetry JSONL path")
    p.add_argument("--f64", action="store_true", help="run in float64")
    p.add_argument("--push", type=float, default=0.0,
                   help="lateral shoulder-push force [N] injected on the "
                        "torso (external_force.cpp analog); 0 = off")
    p.add_argument("--push-at", type=int, default=40,
                   help="control tick the push window starts")
    p.add_argument("--push-ticks", type=int, default=10,
                   help="push window length in control ticks")


def _setup(args):
    import jax
    import jax.numpy as jnp

    from quaternion_mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    from quaternion_mpc_tpu.control import quat_mpc
    from quaternion_mpc_tpu.utils import config as cfg_mod

    table = cfg_mod.presets()
    if args.config not in table:
        raise SystemExit(
            f"unknown --config '{args.config}'; choose from: {', '.join(sorted(table))}"
        )
    cfg = table[args.config]()
    wts = quat_mpc.weights_from_config(cfg, dtype=dtype)
    # controller routing (Main.cpp:69-91): the config key picks the MPC; the
    # quat weights remain the plant's physical truth either way
    if cfg.mpc.controller == "convex":
        from quaternion_mpc_tpu.control import convex_mpc

        args._ctrl_wts = convex_mpc.weights_from_config(cfg, dtype=dtype)
    else:
        args._ctrl_wts = wts
    args._controller = cfg.mpc.controller
    return jax, jnp, dtype, cfg, wts


def _tile(jnp, tree, batch):
    import jax

    return jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), tree)


def _run_loop(args, make_step, init_carry, joy, sp, metric_names):
    """Shared closed-loop driver: scan the fleet step, report metrics.

    make_step() must return a FLEET step over batch-leading pytrees (the
    batch-last solver layout underneath — runtime.step.make_fleet_*)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quaternion_mpc_tpu.utils import telemetry

    vstep = make_step()

    push = float(getattr(args, "push", 0.0) or 0.0)
    if push != 0.0:
        # world-frame shove at a point 0.1 m above the CoM for a window of
        # ticks (the reference's external_force push tool)
        from quaternion_mpc_tpu.sim import plant as plant_mod

        dtype = jnp.asarray(sp.target_height).dtype
        f = jnp.asarray([0.0, push, 0.0], dtype)
        tq = jnp.cross(jnp.asarray([0.0, 0.0, 0.1], dtype), f)
        ext_on = _tile(jnp, plant_mod.ExtWrench(f, tq), args.batch)
        t0, nt = args.push_at, args.push_ticks

        def body(carry, t):
            on = (t >= t0) & (t < t0 + nt)
            ext = jax.tree.map(
                lambda a: jnp.where(on, a, jnp.zeros_like(a)), ext_on
            )
            return vstep(carry, sp, joy, ext_wrench=ext)

        @jax.jit
        def run(carry):
            return jax.lax.scan(body, carry, jnp.arange(args.steps))
    else:
        def body(carry, _):
            return vstep(carry, sp, joy)

        @jax.jit
        def run(carry):
            return jax.lax.scan(body, carry, None, length=args.steps)

    t0 = time.perf_counter()
    carry, metrics = run(init_carry)
    jax.block_until_ready(carry)
    compile_and_run = time.perf_counter() - t0
    # steady-state timing (first call pays XLA compilation)
    t0 = time.perf_counter()
    carry, metrics = run(init_carry)
    jax.block_until_ready(carry)
    wall = time.perf_counter() - t0

    logger = telemetry.TelemetryLogger(args.log)
    out = {
        "steps": args.steps,
        "batch": args.batch,
        "wall_s": round(wall, 3),
        "compile_s": round(compile_and_run - wall, 3),
    }
    m_np = {k: np.asarray(getattr(metrics, k)) for k in metric_names}
    for k, v in m_np.items():
        out[f"{k}_final"] = round(float(v[-1].mean()), 5)
    out["alive_frac"] = round(float(m_np["alive"][-1].mean()), 4)
    out["solves_per_sec"] = round(args.steps * args.batch / wall, 1)
    logger.publish_state(
        fleet_metrics={k: v[-1].mean() for k, v in m_np.items()},
        mpc_time_s=wall / args.steps,
        n_solves=args.batch,
    )
    logger.close()
    return out


def cmd_run_standing(args) -> dict:
    """Standing-balance fleet (SURVEY.md §7 minimum slice)."""
    jax, jnp, dtype, cfg, wts = _setup(args)
    import numpy as np

    from quaternion_mpc_tpu.models import srb
    from quaternion_mpc_tpu.runtime import step as rt

    carry1, sp1 = rt.init_scenario(
        wts, srb.go1_params(dtype=dtype).foot_pos, dtype=dtype,
        ctrl_wts=args._ctrl_wts,
    )
    joy1 = rt.neutral_joy(dtype)
    carry = _tile(jnp, carry1, args.batch)
    sp = _tile(jnp, sp1, args.batch)
    joy = _tile(jnp, joy1, args.batch)

    # perturb initial attitude/velocity per scenario
    rng = np.random.default_rng(0)
    carry = carry._replace(
        plant=carry.plant._replace(
            vel=jnp.asarray(0.05 * rng.standard_normal((args.batch, 3)), dtype)
        )
    )
    return _run_loop(
        args,
        lambda: rt.make_fleet_standing_step(
            horizon=args.horizon, controller=args._controller
        ),
        carry, joy, sp,
        ("height_err", "att_err", "mpc_cost", "alive"),
    )


def cmd_run_trot(args) -> dict:
    """Trot-walking fleet tracking a commanded velocity."""
    jax, jnp, dtype, cfg, wts = _setup(args)

    from quaternion_mpc_tpu.runtime import step as rt

    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    tp = None
    if args.terrain != "flat":
        tp = terrain_mod.make_terrain(args.terrain, dtype=dtype)
    carry1, sp1 = rt.init_walking_scenario(
        wts, dtype=dtype, terrain=tp, ctrl_wts=args._ctrl_wts
    )
    joy1 = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(args.velx, dtype))
    carry = _tile(jnp, carry1, args.batch)
    sp = _tile(jnp, sp1, args.batch)
    joy = _tile(jnp, joy1, args.batch)
    return _run_loop(
        args,
        lambda: rt.make_fleet_walking_step(
            horizon=args.horizon, controller=args._controller
        ),
        carry, joy, sp,
        ("vel_err", "height_err", "mpc_cost", "alive"),
    )


def _gait_pattern(name: str):
    """Gait selection (the reference's set_*_gait_pattern rosparam choices,
    LeggedContactFSM.cpp:87-206). None -> the step factory's default."""
    if name == "default":
        return None
    from quaternion_mpc_tpu.gait import schedule as sched_mod

    return {
        "trot": sched_mod.trot_pattern,
        "trot_stand": sched_mod.trot_with_stand_pattern,
        "crawl": sched_mod.crawl_pattern,
        "stand": sched_mod.stand_pattern,
    }[name]()


def cmd_run_actuated(args) -> dict:
    """Joint-level actuated trot: MPC → torque layer → contact physics
    (sim.articulated; the Gazebo-tier closed loop), vmapped over a fleet."""
    jax, jnp, dtype, cfg, wts = _setup(args)

    from quaternion_mpc_tpu.runtime import step as rt
    from quaternion_mpc_tpu.sim import terrain as terrain_mod

    tp = None
    if args.terrain != "flat":
        tp = terrain_mod.make_terrain(args.terrain, dtype=dtype)
    pattern = _gait_pattern(args.gait)
    gait_freq = args.gait_freq if args.gait_freq > 0 else cfg.gait.gait_freq
    joy1 = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(args.velx, dtype))
    if args.kf_type < 0:
        # ground-truth feedback tier
        carry1, sp1 = rt.init_actuated_scenario(
            wts, dtype=dtype, terrain=tp, pattern=pattern
        )
        step1 = rt.make_actuated_walking_step(
            horizon=args.horizon, n_sub=args.n_sub, pattern=pattern,
            gait_freq=gait_freq, stance_kp_frac=args.stance_kp,
        )
        metric_keys = ("vel_err", "height_err", "mpc_cost", "alive")
    else:
        # full Gazebo-parity loop: estimator + torque + gait + terrain
        carry1, sp1 = rt.init_estimated_actuated_scenario(
            wts, dtype=dtype, terrain=tp, kf_type=args.kf_type,
            pattern=pattern,
        )
        step1 = rt.make_estimated_actuated_step(
            horizon=args.horizon, n_sub=args.n_sub, kf_type=args.kf_type,
            pattern=pattern, gait_freq=gait_freq,
            stance_kp_frac=args.stance_kp,
        )
        metric_keys = ("vel_err", "height_err", "est_err", "mpc_cost", "alive")
    carry = _tile(jnp, carry1, args.batch)
    sp = _tile(jnp, sp1, args.batch)
    joy = _tile(jnp, joy1, args.batch)
    return _run_loop(
        args,
        lambda: jax.vmap(step1),
        carry, joy, sp,
        metric_keys,
    )


def cmd_run_fleet(args) -> dict:
    """Sharded scenario fleet over the device mesh with psum'd metrics and
    optional checkpoint/resume (SURVEY.md §2.3)."""
    jax, jnp, dtype, cfg, wts = _setup(args)
    import numpy as np

    from quaternion_mpc_tpu.models import srb
    from quaternion_mpc_tpu.parallel import mesh as mesh_mod
    from quaternion_mpc_tpu.runtime import step as rt
    from quaternion_mpc_tpu.utils import checkpoint as ckpt

    mesh = mesh_mod.scenario_mesh()
    n_dev = len(mesh.devices.ravel())
    if args.batch % n_dev:
        raise SystemExit(f"--batch must divide the {n_dev}-device mesh")

    walking = args.walk > 0.0
    if walking:
        carry1, sp1 = rt.init_walking_scenario(
            wts, dtype=dtype, ctrl_wts=args._ctrl_wts
        )
        joy1 = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(args.walk, dtype))
    else:
        carry1, sp1 = rt.init_scenario(
            wts, srb.go1_params(dtype=dtype).foot_pos, dtype=dtype,
            ctrl_wts=args._ctrl_wts,
        )
        joy1 = rt.neutral_joy(dtype)
    carry = _tile(jnp, carry1, args.batch)
    sp = _tile(jnp, sp1, args.batch)
    joy = _tile(jnp, joy1, args.batch)

    rng = np.random.default_rng(1)
    carry = carry._replace(
        plant=carry.plant._replace(
            vel=jnp.asarray(0.05 * rng.standard_normal((args.batch, 3)), dtype)
        )
    )
    start_step = 0
    if args.resume:
        carry = ckpt.restore(args.resume, like=carry)
        start_step = int(ckpt.metadata(args.resume).get("step", 0))
        print(f"[fleet] resumed from {args.resume} @ step {start_step}", file=sys.stderr)

    # the batch-LAST fleet solver sharded over the scenario mesh: each device
    # solves its local shard in the batch-last layout, metrics psum across
    # devices (fleet_shard; the vmapped fleet_map path is the slow fallback).
    # --walk shards the WALKING fleet (gait + warm-start state in the
    # sharded carry; parity vs single device in test_multichip)
    if walking:
        step_fn = rt.make_fleet_walking_step(
            horizon=args.horizon, controller=args._controller
        )
    else:
        step_fn = rt.make_fleet_standing_step(
            horizon=args.horizon, controller=args._controller
        )
    fleet = mesh_mod.fleet_shard(step_fn, mesh)
    carry = mesh_mod.shard_batch(carry, mesh)
    sp = mesh_mod.shard_batch(sp, mesh)
    joy = mesh_mod.shard_batch(joy, mesh)

    @jax.jit
    def run(carry):
        def body(c, _):
            return fleet(c, sp, joy)
        return jax.lax.scan(body, carry, None, length=args.steps)

    carry0 = carry
    t0 = time.perf_counter()
    carry, metrics = run(carry0)
    jax.block_until_ready(metrics.mpc_cost)
    compile_and_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    carry, metrics = run(carry0)
    jax.block_until_ready(metrics.mpc_cost)
    wall = time.perf_counter() - t0
    del compile_and_run  # reported implicitly via first-call cost

    if args.checkpoint:
        path = ckpt.save(
            args.checkpoint, jax.device_get(carry),
            metadata={"step": start_step + args.steps, "batch": args.batch},
        )
        print(f"[fleet] checkpoint -> {path}", file=sys.stderr)

    import numpy as np
    return {
        "devices": n_dev,
        "batch": args.batch,
        "steps": args.steps,
        "wall_s": round(wall, 3),
        "solves_per_sec": round(args.steps * args.batch / wall, 1),
        "fleet_alive": round(float(np.asarray(metrics.alive)[-1]) / args.batch, 4),
        "fleet_mean_cost": round(float(np.asarray(metrics.mpc_cost)[-1]) / args.batch, 5),
        "resumed_at": start_step,
    }


def cmd_bench_solver(args) -> dict:
    """Raw solver throughput (the bench.py metric, parameterizable)."""
    jax, jnp, dtype, cfg, wts = _setup(args)
    import numpy as np

    from quaternion_mpc_tpu.control import convex_mpc, quat_mpc
    from quaternion_mpc_tpu.examples import standing_batch as _example_batch
    from quaternion_mpc_tpu.solver import SolverOptions

    if args._controller == "convex":
        ctrl = convex_mpc.make_fleet_controller(
            args.horizon, SolverOptions(al_iterations=1, ilqr_iterations=5)
        )
    else:
        ctrl = quat_mpc.make_fleet_controller(
            args.horizon, SolverOptions(al_iterations=2, ilqr_iterations=5)
        )
    step = jax.jit(ctrl)
    fbk, cmd, wts_b = _example_batch(
        args.batch, args.horizon, dtype, controller=args._controller
    )
    grf, cost = step(fbk, cmd, wts_b)
    jax.block_until_ready(grf)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        grf, cost = step(fbk, cmd, wts_b)
        jax.block_until_ready(grf)
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    return {
        "batch": args.batch,
        "horizon": args.horizon,
        "p50_step_ms": round(p50 * 1e3, 2),
        "solves_per_sec": round(args.batch / p50, 1),
        "per_solve_ms": round(p50 / args.batch * 1e3, 5),
        "mean_cost": round(float(np.mean(np.asarray(cost))), 5),
    }


def cmd_run_hardware(args) -> dict:
    """Main.cpp-shaped hardware loopback demo: native RateLoop/seqlock/UDP
    runtime around the jitted estimator+MPC+torque tick, against the
    articulated UDP sim peer (runtime.hardware_loop). Scripted operator
    flow: default-pose prime (estimator warm-up) → MPC standing balance."""
    _setup(args)
    from quaternion_mpc_tpu.runtime import hardware_loop as hw

    return hw.run_hardware_loopback(
        duration_s=args.duration,
        mpc_rate=args.mpc_rate,
        low_rate=args.low_rate,
        est_rate=args.est_rate,
        prime_s=args.prime,
        walk_s=args.walk,
        velx=args.velx,
        auto_rate=not args.no_auto_rate,
        async_mpc=args.async_mpc,
        async_pullers=args.pullers,
    )


def cmd_viz_forces(args) -> dict:
    """Render GRF vectors along a walking run (the draw_force_plugin role):
    run ONE actuated-trot scenario, record grf_vis telemetry frames, write
    a PNG via utils.visualize.render_forces."""
    jax, jnp, dtype, cfg, wts = _setup(args)

    from quaternion_mpc_tpu.runtime import step as rt
    from quaternion_mpc_tpu.sim import articulated as art_mod
    from quaternion_mpc_tpu.sim import terrain as terrain_mod
    from quaternion_mpc_tpu.utils import telemetry, visualize

    tp = None
    if args.terrain != "flat":
        tp = terrain_mod.make_terrain(args.terrain, dtype=dtype)
    carry, sp = rt.init_actuated_scenario(wts, dtype=dtype, terrain=tp)
    joy = rt.neutral_joy(dtype)._replace(velx=jnp.asarray(args.velx, dtype))
    step = jax.jit(rt.make_actuated_walking_step(horizon=args.horizon))

    logger = telemetry.TelemetryLogger(args.log)
    frames = []
    for _ in range(args.steps):
        carry, m = step(carry, sp, joy)
        rs = carry.robot
        _, fw, fv, _ = art_mod.foot_kinematics(rs, sp.plant)
        f_world, _ = art_mod.contact_forces(fw, fv, sp.plant, rs.anchor)
        rec = {
            "ch": "grf_vis",
            "pos": [float(v) for v in rs.torso.pos],
            "feet": [[float(v) for v in row] for row in fw],
            "grf": [[float(v) for v in row] for row in f_world],
            "contacts": None,
        }
        frames.append(rec)
        logger.publish_forces(rs.torso.pos, fw, f_world)
    out_path = visualize.render_forces(
        frames, args.out, every=max(1, args.steps // 60)
    )
    return {
        "frames": len(frames),
        "out": str(out_path),
        "final_x": float(carry.robot.torso.pos[0]),
        "alive": bool(carry.alive),
    }


def cmd_run_scenario(args) -> dict:
    """Solve a named branch scenario (falling_cat / humanoid / spider_dog)."""
    _setup(args)
    from quaternion_mpc_tpu import scenarios

    if args.name not in scenarios.SCENARIOS:
        raise SystemExit(
            f"unknown --name '{args.name}'; choose from: "
            + ", ".join(sorted(scenarios.SCENARIOS))
        )
    t0 = time.perf_counter()
    if args.closed_loop:
        summary = scenarios.run_closed_loop(args.name, n_ticks=args.steps)
    else:
        _sol, summary = scenarios.solve_scenario(args.name)
    summary["name"] = args.name
    summary["closed_loop"] = bool(args.closed_loop)
    summary["wall_s"] = round(time.perf_counter() - t0, 3)
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="quaternion_mpc_tpu")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run_standing", help="standing-balance fleet")
    _common(p)
    p.set_defaults(fn=cmd_run_standing)

    p = sub.add_parser("run_trot", help="trot-walking fleet")
    _common(p)
    p.add_argument("--velx", type=float, default=0.4, help="commanded m/s")
    p.add_argument("--terrain", default="flat",
                   help="world: flat | slope | stairs | space")
    p.set_defaults(fn=cmd_run_trot)

    p = sub.add_parser("run_actuated", help="joint-level torque-driven trot fleet")
    _common(p)
    p.add_argument("--velx", type=float, default=0.4, help="commanded m/s")
    p.add_argument("--terrain", default="flat",
                   help="world: flat | slope | stairs | space")
    p.add_argument("--n_sub", type=int, default=80,
                   help="physics substeps per MPC tick (80 = 0.125 ms at h=10 ms)")
    p.add_argument("--gait", default="default",
                   choices=["default", "trot", "trot_stand", "crawl", "stand"],
                   help="gait pattern (LeggedContactFSM tables); e.g. "
                        "--gait crawl --gait_freq 1.0 climbs moderate stairs")
    p.add_argument("--gait_freq", type=float, default=0.0,
                   help="gait frequency [Hz]; 0 = config preset")
    p.add_argument("--stance_kp", type=float, default=0.0,
                   help="fraction of the position anchor kept on stance "
                        "legs (0 = walk convention; ~0.3 for stairs)")
    p.add_argument("--kf_type", type=int, default=-1,
                   help="-1: ground-truth feedback; 0/1/2: full estimated "
                        "loop (truth passthrough / BasicKF / EKF+mocap)")
    p.set_defaults(fn=cmd_run_actuated)

    p = sub.add_parser("run_fleet", help="mesh-sharded fleet w/ checkpointing")
    _common(p)
    p.add_argument("--checkpoint", default=None, help="save carry here at end")
    p.add_argument("--resume", default=None, help="restore carry from here")
    p.add_argument("--walk", type=float, default=0.0,
                   help="shard the WALKING fleet at this velx [m/s] "
                        "(0 = standing balance)")
    p.set_defaults(fn=cmd_run_fleet)

    p = sub.add_parser("bench_solver", help="raw solver throughput")
    _common(p)
    p.add_argument("--iters", type=int, default=10)
    p.set_defaults(fn=cmd_bench_solver)

    p = sub.add_parser("run_scenario", help="branch configs: falling_cat / humanoid / spider_dog")
    _common(p)
    p.add_argument("--name", required=True)
    p.add_argument("--closed_loop", action="store_true",
                   help="receding-horizon closed loop on the scenario's "
                        "plant (re-solve each tick) instead of one open-"
                        "loop solve; --steps sets the tick count")
    p.set_defaults(fn=cmd_run_scenario)

    p = sub.add_parser(
        "viz_forces",
        help="render GRF vectors along a trot (draw_force_plugin role)",
    )
    _common(p)
    p.add_argument("--velx", type=float, default=0.4)
    p.add_argument("--terrain", default="flat")
    p.add_argument("--out", default="forces.png")
    p.set_defaults(fn=cmd_viz_forces)

    p = sub.add_parser(
        "run_hardware",
        help="Main.cpp-shaped loopback: RateLoop threads + UDP sim peer",
    )
    _common(p)
    p.add_argument("--duration", type=float, default=2.0, help="MPC phase [s]")
    p.add_argument("--prime", type=float, default=0.6,
                   help="default-pose/estimator warm-up phase [s]")
    p.add_argument("--walk", type=float, default=0.0,
                   help="trot phase length [s] (A-press toggled; 0 = stand only)")
    p.add_argument("--velx", type=float, default=0.3, help="walk speed [m/s]")
    p.add_argument("--mpc_rate", type=float, default=50.0)
    p.add_argument("--low_rate", type=float, default=250.0)
    p.add_argument("--est_rate", type=float, default=0.0,
                   help="estimator (feedback) thread rate [Hz]; > 0 enables "
                        "the reference's three-tier thread shape "
                        "(Main.cpp:88-207), 0 folds the KF into the MPC tick")
    p.add_argument("--no_auto_rate", action="store_true",
                   help="keep the requested MPC rate even if the measured "
                        "tick time cannot sustain it (count overruns)")
    p.add_argument("--async_mpc", action="store_true",
                   help="pipelined one-tick-delay MPC dispatch: rate bound "
                        "by solve throughput, not dispatch latency")
    p.add_argument("--pullers", type=int, default=0,
                   help="pipelined-POOL dispatch: N puller threads wait for "
                        "results off the MPC thread's critical path "
                        "(sequence-guarded publish, lead-compensated tick); "
                        "hides a slow result pull at ~N/pull-time commands/s")
    p.set_defaults(fn=cmd_run_hardware)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = args.fn(args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
