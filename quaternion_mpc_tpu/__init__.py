"""quaternion_mpc_tpu — a batched quaternion model-predictive-control framework.

A from-scratch JAX/XLA re-design of the capabilities of the
``zixinz990/quaternion-mpc`` C++/ROS quadruped control stack (singularity-free
quaternion MPC, Euler convex-MPC baseline, gait/swing/kinematics/estimation
layers), built for accelerators:

- pure, batched, jittable functions over pytrees (no threads, no mutexes),
- a batched quaternion AL-iLQR trajectory optimizer (`solver/`),
- scenario fleets via `jax.vmap` + `jax.sharding` meshes (`parallel/`),
- an in-framework batched SRB plant replacing Gazebo (`sim/`).

Reference layer map: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"

import jax

# Full-f32 matrix products everywhere. On a GPU an f32 `@` at JAX's default
# precision may run in TF32 (about three decimal digits), which is too
# coarse for the solver's Riccati recursion and the Kalman filters'
# covariance algebra: on an H100 the BasicKF's covariance after one tick
# differed from an f64 reference by 8e-4 at default precision and by 4e-7
# at full f32. A no-op on the CPU.
jax.config.update("jax_default_matmul_precision", "highest")

from quaternion_mpc_tpu.ops import lie  # noqa: E402,F401
