"""Horizon-parallel Riccati backward pass via `jax.lax.associative_scan`.

The reference solves its MPC horizon strictly sequentially inside ALTRO's
Riccati recursion (SURVEY.md §5 "long-context" analog; the un-vendored fork
behind ``legged_ctrl/CMakeLists.txt:35-40``). This module is the
"sequence parallelism" for that axis: the LQR value recursion is a
composition of linear-fractional (Riccati) maps, which is ASSOCIATIVE — so
the N-step backward pass can run as an associative scan with O(log N) serial
depth (temporal parallelization of LQT, Särkkä & García-Fernández 2020).

Where it should pay: at large B the scenario batch already fills the
device, so horizon parallelism buys little and its extra algebra costs. At
SMALL batch — the single-robot 200 Hz latency contract (``Main.cpp:115``)
and long horizons (N=20-30, ``gazebo_go1_quat_mpc.yaml:37``,
``LeggedState.cpp:116``) — the N-step serial chain IS the critical path,
and log₂(N) combines of (ne+ne)-sized batched algebra shorten it. Hence
``make_fleet_solver(backend="auto")`` routes B == 1 here and every fleet to
the sequential sweep (which is also bit-stable for the fleet==single parity
tests). Where the crossover lies on the H100 is unmeasured; chip_smoke.py
prints ms/tick for both backends at B=1, N=20.

Formulation (conditional value elements, one per knot + one terminal):

    E_k(x, x') = max_λ { ½xᵀJx − ηᵀx + λᵀ(x' − Ax − b) − ½λᵀCλ }

    one-step init (dynamics x' = Fx + Lu; stage cost ½xᵀXx + qᵀx
    + ½uᵀUu + rᵀu):   A=F, b=−LU⁻¹r, C=LU⁻¹Lᵀ, J=X, η=−q
    terminal (V_N = ½xᵀ lxxN x + lxNᵀx):  A=0, b=0, C=0, J=lxxN, η=−lxN

    combine (e₁ earlier, e₂ later), with P = (I + C₁J₂)⁻¹:
    A = A₂PA₁;  b = A₂P(b₁ + C₁η₂) + b₂;  C = A₂PC₁A₂ᵀ + C₂
    J = A₁ᵀ(I + J₂C₁)⁻¹J₂A₁ + J₁;  η = A₁ᵀ(I + J₂C₁)⁻¹(η₂ − J₂b₁) + η₁
    (signs pinned by an associativity check + equality with the sequential
    pass; see tests/test_parallel_riccati.py)

A reverse associative scan then yields V_{k} = (J, η) at every knot at once;
per-knot gains K_k, d_k follow in one vmapped (horizon-parallel) solve.
All algebra is batch-LAST ((..., n, m, B) stacks) matching solver/fleet.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from quaternion_mpc_tpu.solver import fleet as fl


def _mm(A, B):
    """(..., n, k, B) @ (..., k, m, B) -> (..., n, m, B)."""
    return jnp.sum(A[..., :, :, None, :] * B[..., None, :, :, :], axis=-3)


def _mv(A, x):
    """(..., n, k, B) @ (..., k, B) -> (..., n, B)."""
    return jnp.sum(A * x[..., None, :, :], axis=-2)


def _tt(A):
    return jnp.swapaxes(A, -3, -2)


def _solve_general(A, rhs):
    """Gauss-Jordan solve of (..., n, n, B) against (..., n, m, B).

    No pivoting: callers pass I + (PSD·PSD) matrices whose spectrum lies in
    [1, ∞) up to similarity, so the diagonal stays away from zero.

    An unrolled row loop rather than XLA's batched LU (`jnp.linalg.solve`):
    a custom call per scan level cannot fuse with the combine's products.
    Which is faster on the H100 is unmeasured."""
    n = A.shape[-3]
    M = jnp.concatenate([A, rhs], axis=-2)
    for j in range(n):
        pivot = M[..., j, j, :]
        row_j = M[..., j, :, :] / pivot[..., None, :]
        factors = M[..., :, j, :]
        M = M - factors[..., :, None, :] * row_j[..., None, :, :]
        M = jnp.concatenate(
            [M[..., :j, :, :], row_j[..., None, :, :], M[..., j + 1 :, :, :]],
            axis=-3,
        )
    return M[..., :, n:, :]


def _combine(e1, e2):
    """Associative composition of value elements: e1 covers the EARLIER
    interval, e2 the later (their boundary state is minimized out).

    ONE Gauss-Jordan with a stacked RHS instead of five: with
    P = (I + C1J2)⁻¹, the push-through identity (I + J2C1)⁻¹J2 = J2·P and
    the Woodbury form (I + J2C1)⁻¹ = I − J2·P·C1 turn every (I + J2C1)⁻¹
    application into a reuse of P applied to [A1 | b1 + C1η2 | C1]:
        (I+J2C1)⁻¹ J2 A1        = J2 · (P A1)
        (I+J2C1)⁻¹ (η2 − J2 b1) = η2 − J2 · P (b1 + C1 η2)
    The backward scan's serial depth is dominated by the in-combine
    elimination, so collapsing 5 solves into 1 is the latency lever
    (measured: N=20 B=1 cold tick 6.6 → see bench)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    n = A1.shape[-3]
    r = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    eye = (r == c).astype(A1.dtype)[..., None]

    ICJ = eye + _mm(C1, J2)             # I + C1 J2
    rhs = jnp.concatenate(
        [A1, (b1 + _mv(C1, eta2))[..., None, :], C1], axis=-2
    )
    sol = _solve_general(ICJ, rhs)
    P_A1 = sol[..., :, :n, :]
    P_bCe = sol[..., :, n, :]
    P_C1 = sol[..., :, n + 1 :, :]

    J2_P_A1 = _mm(J2, P_A1)

    A = _mm(A2, P_A1)
    b = _mv(A2, P_bCe) + b2
    C = _mm(A2, _mm(P_C1, _tt(A2))) + C2
    eta = _mv(_tt(A1), eta2 - _mv(J2, P_bCe)) + eta1
    J = _mm(_tt(A1), J2_P_A1) + J1
    return (A, b, C, eta, J)


def parallel_backward(spec, prob, xs, us, lam, rho, reg):
    """Drop-in for `fleet.riccati_backward`: same inputs, same outputs
    (Ks, ds, dV1, dV2, gnorm) — the N-step recursion replaced by an
    associative scan of depth ⌈log₂(N+1)⌉.

    The per-knot expansions are horizon-parallel already (one vmap); the
    value functions V_k = (S_k, v_k) for ALL knots come out of one
    associative scan; the gains follow in one more vmap.
    """
    ne, nu = spec.ne, spec.nu
    N = us.shape[0]
    B = xs.shape[-1]
    dtype = xs.dtype

    As, Bs, lxs, lxxs, lus, luus = fl.knot_expansions(spec, prob, xs, us, lam, rho)
    lxN, lxxN = fl.terminal_expansion(spec, xs[N], prob)

    r = jax.lax.broadcasted_iota(jnp.int32, (nu, nu), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (nu, nu), 1)
    eye_u = (r == c).astype(dtype)[..., None]

    # one-step elements: U = luu + reg·I (regularized value propagation);
    # Uinv via the SPD Gauss-Jordan on the (nu, nu, B) stacks
    Us = luus + reg * eye_u
    # U⁻¹Lᵀ per knot: (N, nu, ne, B)
    LUinvT = jax.vmap(lambda U, L: fl.solve_spd_multi(U, [fl.bt(L)])[0])(Us, Bs)
    # A=F, b=−L U⁻¹ r, C=L U⁻¹ Lᵀ, J=X, η=−q  (U symmetric: LU⁻¹ = (U⁻¹Lᵀ)ᵀ)
    b0 = -jax.vmap(lambda M, r2: fl.bmv(fl.bt(M), r2))(LUinvT, lus)
    C0 = jax.vmap(fl.bmm)(Bs, LUinvT)                    # L · (U⁻¹Lᵀ)
    elems = (
        jnp.concatenate([As, jnp.zeros((1, ne, ne, B), dtype)], axis=0),
        jnp.concatenate([b0, jnp.zeros((1, ne, B), dtype)], axis=0),
        jnp.concatenate([C0, jnp.zeros((1, ne, ne, B), dtype)], axis=0),
        jnp.concatenate([-lxs, -lxN[None]], axis=0),
        jnp.concatenate([lxxs, lxxN[None]], axis=0),
    )

    # reverse associative scan: out[k] = e_k ∘ e_{k+1} ∘ … ∘ e_N.
    # reverse=True is implemented as flip→scan→flip, so the combine fn
    # receives its operands in flipped (later, earlier) order — swap back.
    out = jax.lax.associative_scan(
        lambda a, b: _combine(b, a), elems, reverse=True, axis=0
    )
    S = out[4]          # (N+1, ne, ne, B): Vxx at every knot
    v = -out[3]         # (N+1, ne, B):    Vx at every knot

    # horizon-parallel gains from V_{k+1}
    def gains(A, B_, lx, lxx, lu, luu, S1, v1):
        BtS = fl.bmm(fl.bt(B_), S1)
        Qu = lu + fl.bmv(fl.bt(B_), v1)
        Quu = luu + fl.bmm(BtS, B_)
        Qux = fl.bmm(BtS, A)
        d, K = fl.solve_spd_multi(Quu + reg * eye_u, [Qu, Qux])
        d, K = -d, -K
        dV1 = jnp.sum(d * Qu, axis=0)
        dV2 = 0.5 * jnp.sum(d * fl.bmv(Quu, d), axis=0)
        return K, d, dV1, dV2, jnp.max(jnp.abs(Qu), axis=0)

    Ks, ds, dV1s, dV2s, gs = jax.vmap(gains)(
        As, Bs, lxs, lxxs, lus, luus, S[1:], v[1:]
    )
    return Ks, ds, jnp.sum(dV1s, axis=0), jnp.sum(dV2s, axis=0), jnp.max(gs, axis=0)
