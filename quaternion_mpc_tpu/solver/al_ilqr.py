"""Batched quaternion AL-iLQR trajectory optimizer.

Re-derivation of the algorithm behind the reference's un-vendored ALTRO fork
(``legged_ctrl/CMakeLists.txt:35-40`` pins ``zixinz990/altro``; call-site API
in ``QuatMpc.cpp:218-256``): an augmented-Lagrangian outer loop over an
error-state iLQR/Riccati inner loop, with quaternion states handled on the
Cayley chart ("Planning with Attitude" machinery; the reference exposes the
projection matrices in ``AltroUtils.cpp:128-221``).

Design decisions for batched accelerators (SURVEY.md §7 "hard parts"):
- batch-uniform control flow: fixed AL/iLQR iteration counts with masked
  early-exit, `lax.scan` Riccati sweeps, `lax.while_loop` backtracking
  line search — all vmappable over a scenario batch axis;
- the entire solve is one compiled function: no per-tick problem rebuild,
  no host round-trips;
- expansions are computed for all knots at once (vmap over the horizon);
  only the Riccati recursion is sequential.

Math summary (error state e ∈ R^ne, E(x) = blkdiag(I, G(q), I)):
  A_k = E(x̄_{k+1})ᵀ ∂f_d/∂x E(x̄_k),   B_k = E(x̄_{k+1})ᵀ ∂f_d/∂u
  stage cost expansion at x̄:  l_x = E(x̄)ᵀ g,  l_xx = E(x̄)ᵀ ∇²J E(x̄) + c·I_φ
  with the chart-curvature correction c = −qᵀ(∂J/∂q) on the attitude block
  (for the geodesic cost w(1−|q_refᵀq|): c = w·|q_refᵀq̄|).
  AL inequality terms (c(u) = Cu·u + cb ≤ 0, multipliers λ ≥ 0, penalty ρ):
    J_AL += (‖max(0, λ+ρc)‖² − ‖λ‖²)/(2ρ);   λ⁺ = max(0, λ + ρc).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from quaternion_mpc_tpu.models import discretize
from quaternion_mpc_tpu.solver.problem import (
    CostSpec,
    ModelSpec,
    Solution,
    SolveStats,
    SolverOptions,
    TrajOptProblem,
)


# ---------------------------------------------------------------------------
# Cost pieces
# ---------------------------------------------------------------------------


def _quat_cost_terms(x, Qd, w, x_ref, quat_idx):
    """(value, full-space gradient, attitude Hessian correction scalar)."""
    dx = x - x_ref
    val = 0.5 * jnp.sum(Qd * dx * dx)
    g = Qd * dx
    if quat_idx is None:
        return val, g, jnp.zeros((), dtype=x.dtype)
    q = x[quat_idx : quat_idx + 4]
    q_ref = x_ref[quat_idx : quat_idx + 4]
    dot = jnp.sum(q * q_ref)
    s = jnp.sign(dot)
    val = val + w * (1.0 - jnp.abs(dot))
    g = g.at[quat_idx : quat_idx + 4].add(-w * s * q_ref)
    # chart curvature: −qᵀ(∂J/∂q) (includes any quadratic quat weights)
    corr = -jnp.sum(q * g[quat_idx : quat_idx + 4])
    return val, g, corr


def _w_at(w, k):
    """Per-knot geodesic weight: w may be a scalar or a (N+1,) array
    (SetQuaternionCost is called per knot in the reference, QuatMpc.cpp:227)."""
    return w if jnp.ndim(w) == 0 else w[k]


def _al_penalty(c, lam, rho):
    lam_bar = jnp.maximum(0.0, lam + rho * c)
    return (jnp.sum(lam_bar * lam_bar) - jnp.sum(lam * lam)) / (2.0 * rho)


def _terminal_expansion(xN, cost: CostSpec, spec: ModelSpec, prob=None, lamN=None, rho=None):
    Qdf = cost.Qd if cost.Qdf is None else cost.Qdf
    _, gN, corrN = _quat_cost_terms(xN, Qdf, _w_at(cost.w, -1), cost.x_ref[-1], spec.quat_idx)
    EN = discretize.error_projection(xN, spec.quat_idx, spec.ne)
    lxN = EN.T @ gN
    lxxN = EN.T @ (Qdf[:, None] * EN)
    if spec.quat_idx is not None:
        att = jnp.arange(spec.quat_idx, spec.quat_idx + 3)
        lxxN = lxxN.at[att, att].add(corrN)
    if prob is not None and prob.Cx is not None:
        c = prob.Cx @ xN + _cb_at(prob.cb, -1)
        lam_bar = jnp.maximum(0.0, lamN + rho * c)
        active = (lamN + rho * c) >= 0.0
        CxE = prob.Cx @ EN
        lxN = lxN + CxE.T @ lam_bar
        lxxN = lxxN + rho * (CxE.T * active[None, :]) @ CxE
    return lxN, lxxN


# ---------------------------------------------------------------------------
# Dynamics helpers
# ---------------------------------------------------------------------------


def _discrete_jacobian(spec: ModelSpec, x, u, params, h):
    fj = spec.fj if spec.fj is not None else discretize.autodiff_jacobian(spec.f)
    if spec.integrator == "midpoint":
        return discretize.midpoint_jacobian(spec.f, fj, x, u, params, h)
    return discretize.euler_jacobian(spec.f, fj, x, u, params, h)


def _discrete_step(spec: ModelSpec, x, u, params, h):
    if spec.integrator == "midpoint":
        return discretize.midpoint_step(spec.f, x, u, params, h)
    return discretize.euler_step(spec.f, x, u, params, h)


# ---------------------------------------------------------------------------
# Main solver factory
# ---------------------------------------------------------------------------


def _cb_at(cb, k):
    """Per-knot constraint offset: cb may be (nc,) shared across the horizon
    or (N+1, nc) time-varying (per-knot contact gating of the friction cone,
    the schedule the reference's ConvexMpc.cpp:82 TODO never wired)."""
    return cb if cb.ndim == 1 else cb[k]


def make_solver(spec: ModelSpec, opts: SolverOptions = SolverOptions()):
    """Build a jittable single-problem solver; `jax.vmap` it for fleets."""

    def constraint_val(prob, x, u, k):
        c = prob.Cu @ u + _cb_at(prob.cb, k)
        if prob.Cx is not None:
            c = c + prob.Cx @ x
        return c

    def total_cost(xs, us, prob, lam, rho):
        cost = prob.cost
        N = us.shape[0]

        def stage(k):
            kc = CostSpec(cost.Qd, cost.Rd, _w_at(cost.w, k), cost.x_ref[k], cost.u_ref[k])
            val, _, _ = _quat_cost_terms(xs[k], kc.Qd, kc.w, kc.x_ref, spec.quat_idx)
            du = us[k] - kc.u_ref
            val = val + 0.5 * jnp.sum(kc.Rd * du * du)
            c = constraint_val(prob, xs[k], us[k], k)
            return val + _al_penalty(c, lam[k], rho)

        stage_costs = jax.vmap(stage)(jnp.arange(N))
        Qdf = cost.Qd if cost.Qdf is None else cost.Qdf
        term_val, _, _ = _quat_cost_terms(
            xs[N], Qdf, _w_at(cost.w, -1), cost.x_ref[N], spec.quat_idx
        )
        if prob.Cx is not None:
            cN = prob.Cx @ xs[N] + _cb_at(prob.cb, N)
            term_val = term_val + _al_penalty(cN, lam[N], rho)
        return jnp.sum(stage_costs) + term_val

    def backward_pass(As, Bs, lxs, lxxs, lus, luus, luxs, lxN, lxxN, reg):
        nu = Bs.shape[-1]
        eye_u = jnp.eye(nu, dtype=Bs.dtype)

        def step(carry, inp):
            Vx, Vxx = carry
            A, B, lx, lxx, lu, luu, lux = inp
            Qx = lx + A.T @ Vx
            Qu = lu + B.T @ Vx
            Qxx = lxx + A.T @ Vxx @ A
            Quu = luu + B.T @ Vxx @ B
            Qux = lux + B.T @ Vxx @ A
            chol = jnp.linalg.cholesky(Quu + reg * eye_u)
            d = -jax.scipy.linalg.cho_solve((chol, True), Qu)
            K = -jax.scipy.linalg.cho_solve((chol, True), Qux)
            Vx_new = Qx + K.T @ Quu @ d + K.T @ Qu + Qux.T @ d
            Vxx_new = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
            dV1 = jnp.dot(d, Qu)
            dV2 = 0.5 * jnp.dot(d, Quu @ d)
            gnorm = jnp.max(jnp.abs(Qu))
            return (Vx_new, Vxx_new), (K, d, dV1, dV2, gnorm)

        (_, _), (Ks, ds, dV1s, dV2s, gnorms) = jax.lax.scan(
            step, (lxN, lxxN), (As, Bs, lxs, lxxs, lus, luus, luxs), reverse=True
        )
        return Ks, ds, jnp.sum(dV1s), jnp.sum(dV2s), jnp.max(gnorms)

    def rollout(prob, xs_bar, us_bar, Ks, ds, alpha):
        def step(x, inp):
            x_bar, u_bar, K, d = inp
            dx = discretize.state_diff(x, x_bar, spec.quat_idx)
            u = u_bar + alpha * d + K @ dx
            x_next = _discrete_step(spec, x, u, prob.params, prob.h)
            return x_next, (x, u)

        xN, (xs, us) = jax.lax.scan(step, xs_bar[0], (xs_bar[:-1], us_bar, Ks, ds))
        return jnp.concatenate([xs, xN[None]], axis=0), us

    def solve_fn(prob: TrajOptProblem) -> Solution:
        cost = prob.cost
        N = prob.us_init.shape[0]
        dtype = prob.x0.dtype
        nc = prob.cb.shape[-1]

        def ilqr_iteration(state):
            xs, us, lam, rho, reg, J, done, n_iter, gnorm_prev = state

            def dyn_exp(k):
                Jd = _discrete_jacobian(spec, xs[k], us[k], prob.params, prob.h)
                E_k = discretize.error_projection(xs[k], spec.quat_idx, spec.ne)
                E_k1 = discretize.error_projection(xs[k + 1], spec.quat_idx, spec.ne)
                return E_k1.T @ Jd[:, : spec.nx] @ E_k, E_k1.T @ Jd[:, spec.nx :]

            As, Bs = jax.vmap(dyn_exp)(jnp.arange(N))

            def cost_exp(k):
                kc = CostSpec(cost.Qd, cost.Rd, _w_at(cost.w, k), cost.x_ref[k], cost.u_ref[k])
                _, g, corr = _quat_cost_terms(xs[k], kc.Qd, kc.w, kc.x_ref, spec.quat_idx)
                E = discretize.error_projection(xs[k], spec.quat_idx, spec.ne)
                lx = E.T @ g
                lxx = E.T @ (kc.Qd[:, None] * E)
                if spec.quat_idx is not None:
                    att = jnp.arange(spec.quat_idx, spec.quat_idx + 3)
                    lxx = lxx.at[att, att].add(corr)
                lu = kc.Rd * (us[k] - kc.u_ref)
                luu = jnp.diag(kc.Rd)
                c = constraint_val(prob, xs[k], us[k], k)
                lam_bar = jnp.maximum(0.0, lam[k] + rho * c)
                active = (lam[k] + rho * c) >= 0.0
                lu = lu + prob.Cu.T @ lam_bar
                luu = luu + rho * (prob.Cu.T * active[None, :]) @ prob.Cu
                lux = jnp.zeros((spec.nu, spec.ne), dtype=xs.dtype)
                if prob.Cx is not None:
                    CxE = prob.Cx @ E
                    lx = lx + CxE.T @ lam_bar
                    lxx = lxx + rho * (CxE.T * active[None, :]) @ CxE
                    lux = lux + rho * (prob.Cu.T * active[None, :]) @ CxE
                return lx, lxx, lu, luu, lux

            lxs, lxxs, lus, luus, luxs = jax.vmap(cost_exp)(jnp.arange(N))
            lxN, lxxN = _terminal_expansion(xs[N], cost, spec, prob, lam[N], rho)

            Ks, ds, dV1, dV2, gnorm = backward_pass(
                As, Bs, lxs, lxxs, lus, luus, luxs, lxN, lxxN, reg
            )

            def ls_cond(ls):
                _, _, _, accepted, tries = ls
                return jnp.logical_and(~accepted, tries < opts.max_linesearch)

            def ls_body(ls):
                alpha, _, _, _, tries = ls
                xs_new, us_new = rollout(prob, xs, us, Ks, ds, alpha)
                J_new = total_cost(xs_new, us_new, prob, lam, rho)
                expected = -(alpha * dV1 + alpha * alpha * dV2)
                ok = jnp.where(
                    expected > 0.0,
                    (J - J_new) / jnp.maximum(expected, 1e-30) > 1e-4,
                    J_new < J + 1e-12,
                )
                ok = jnp.logical_and(ok, jnp.isfinite(J_new))
                return (alpha * 0.5, (xs_new, us_new), J_new, ok, tries + 1)

            ls0 = (
                jnp.asarray(1.0, dtype),
                (xs, us),
                J,
                jnp.asarray(False),
                jnp.asarray(0),
            )
            _, (xs_ls, us_ls), J_ls, accepted, _ = jax.lax.while_loop(
                ls_cond, ls_body, ls0
            )

            improved = jnp.logical_and(accepted, J_ls < J)
            take = jnp.logical_and(improved, ~done)
            xs_out = jnp.where(take, xs_ls, xs)
            us_out = jnp.where(take, us_ls, us)
            J_out = jnp.where(take, J_ls, J)
            reg_out = jnp.where(
                improved,
                jnp.maximum(reg / opts.reg_scale_up, opts.reg_initial),
                jnp.minimum(reg * opts.reg_scale_up, opts.reg_max),
            )
            conv = jnp.logical_or(jnp.abs(J - J_out) < opts.cost_tol, gnorm < opts.grad_tol)
            done_out = jnp.logical_or(done, jnp.logical_or(conv, ~accepted))
            return (
                xs_out,
                us_out,
                lam,
                rho,
                reg_out,
                J_out,
                done_out,
                n_iter + (~done).astype(jnp.int32),
                gnorm,
            )

        # initial dynamically-feasible rollout from the input warm start
        def init_step(x, u):
            return _discrete_step(spec, x, u, prob.params, prob.h), x

        xN0, xs0 = jax.lax.scan(init_step, prob.x0, prob.us_init)
        xs = jnp.concatenate([xs0, xN0[None]], axis=0)
        us = prob.us_init

        # multipliers: one row per stage knot + a terminal row (used only for
        # state constraints; stays zero otherwise). lam_init = dual warm
        # start carried from the previous tick (RTI scheme).
        lam = (
            jnp.zeros((N + 1, nc), dtype=dtype)
            if prob.lam_init is None else prob.lam_init
        )
        rho = jnp.asarray(opts.penalty_initial, dtype)
        reg = jnp.asarray(opts.reg_initial, dtype)
        total_iters = jnp.asarray(0, jnp.int32)
        gnorm = jnp.asarray(jnp.inf, dtype)

        # Both loops are lax.scans so the iteration body is traced/compiled
        # once, not unrolled al_iterations × ilqr_iterations times.
        def al_body(carry, _):
            xs, us, lam, rho, reg, total_iters, gnorm = carry
            J = total_cost(xs, us, prob, lam, rho)
            state = (
                xs,
                us,
                lam,
                rho,
                reg,
                J,
                jnp.asarray(False),
                jnp.asarray(0, jnp.int32),
                gnorm,
            )
            state, _ = jax.lax.scan(
                lambda s, _: (ilqr_iteration(s), None),
                state,
                None,
                length=opts.ilqr_iterations,
            )
            xs, us, lam, rho, reg, J, _, n_inner, gnorm = state
            cvals = jax.vmap(lambda x, u, k: constraint_val(prob, x, u, k))(
                xs[:-1], us, jnp.arange(us.shape[0])
            )
            lam = lam.at[:-1].set(jnp.maximum(0.0, lam[:-1] + rho * cvals))
            if prob.Cx is not None:
                cN = prob.Cx @ xs[-1] + _cb_at(prob.cb, -1)
                lam = lam.at[-1].set(jnp.maximum(0.0, lam[-1] + rho * cN))
            rho = rho * opts.penalty_scaling
            return (xs, us, lam, rho, reg, total_iters + n_inner, gnorm), None

        carry = (xs, us, lam, rho, reg, total_iters, gnorm)
        carry, _ = jax.lax.scan(al_body, carry, None, length=opts.al_iterations)
        xs, us, lam, rho, reg, total_iters, gnorm = carry

        cvals = jax.vmap(lambda x, u, k: constraint_val(prob, x, u, k))(
            xs[:-1], us, jnp.arange(us.shape[0])
        )
        viol = (
            jnp.max(jnp.maximum(cvals, 0.0)) if nc > 0 else jnp.zeros((), dtype)
        )
        raw_cost = total_cost(xs, us, prob, jnp.zeros_like(lam), jnp.asarray(1.0, dtype) * 1e-30)
        stats = SolveStats(
            cost=raw_cost,
            constraint_violation=viol,
            grad_norm=gnorm,
            iterations=total_iters,
        )
        return Solution(xs=xs, us=us, stats=stats, lam=lam)

    return solve_fn


def solve(spec: ModelSpec, prob: TrajOptProblem, opts: SolverOptions = SolverOptions()):
    """Convenience one-shot solve (wrap in jax.jit with static spec/opts for reuse)."""
    return make_solver(spec, opts)(prob)
