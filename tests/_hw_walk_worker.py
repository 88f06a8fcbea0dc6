"""Subprocess worker for the three-tier walk-survival test: one loopback
walk in a FRESH interpreter (fresh heap, no accumulated jit caches or GC
pressure from earlier tests), summary as one JSON line on stdout."""

import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:  # repo-local persistent compile cache keeps worker startup fast
    cache = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"
    jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
except Exception:
    pass

from quaternion_mpc_tpu.runtime import hardware_loop as hl  # noqa: E402


def main():
    # QMPC_WALK_MODE=pool100: the pipelined-pool config — 100 Hz MPC with
    # 4 puller threads and lead compensation (the control stack itself
    # sustains >=100 Hz; see hardware_loop.run_hardware_loopback).
    if os.environ.get("QMPC_WALK_MODE") == "pool100":
        s = hl.run_hardware_loopback(
            duration_s=0.7, prime_s=0.6, walk_s=1.2, velx=0.3,
            mpc_rate=100.0, est_rate=150.0, low_rate=150.0,
            async_pullers=4,
        )
    else:
        s = hl.run_hardware_loopback(
            duration_s=0.7, prime_s=0.6, walk_s=1.2, velx=0.3,
            est_rate=150.0, low_rate=150.0,
        )
    out = {k: v for k, v in s.items() if isinstance(v, (int, float, bool))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
