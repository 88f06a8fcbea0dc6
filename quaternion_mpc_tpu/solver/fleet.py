"""Fleet-native AL-iLQR: the same algorithm as `al_ilqr`, restructured so
that every array carries the scenario batch as its LAST axis.

Why: under `jax.vmap` the batch leads, so a (B, 13) state puts the tiny
matrix dims in the minor (contiguous) axis and every op in the Riccati
recursion works on 12- and 13-wide rows. With batch-last, (13, B), the
contiguous axis is the batch: each tiny-matrix product becomes elementwise
work over B scenarios at once. Whether this layout is the right one for the
H100 is unmeasured.

The linear algebra on (n, n, B) stacks (matmul, Cholesky, triangular solve)
is unrolled over the static tiny dims — XLA fuses the scalar-chain into a
few batch-parallel kernels. Shapes:

    xs (N+1, nx, B)   us (N, nu, B)   As (N, ne, ne, B)   Ks (N, nu, ne, B)

Model callables are fleet-native too: f(x, u, params) with x (nx, B) and
per-scenario params broadcast on the trailing axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from quaternion_mpc_tpu.solver.problem import SolverOptions

# ---------------------------------------------------------------------------
# Batch-last tiny linear algebra
# ---------------------------------------------------------------------------


# Tiny-matrix contractions as broadcast-multiply + sum, NOT einsum/dot:
# dot_general on batch-trailing (n, k, B) stacks compiles to standalone
# matrix-unit kernels that cannot fuse with their neighbours, while the
# mul+sum form is elementwise+reduce that XLA fuses across the whole
# backward pass. It is full f32 whatever the matmul precision (the package
# pins HIGHEST anyway: reduced-precision products degrade AL-iLQR
# convergence). Whether dot_general fuses better on the H100 is unmeasured.


def bmm(A, B):
    """(n, k, B) @ (k, m, B) -> (n, m, B)."""
    return jnp.sum(A[:, :, None, :] * B[None, :, :, :], axis=1)


def bmv(A, x):
    """(n, k, B) @ (k, B) -> (n, B)."""
    return jnp.sum(A * x[None, :, :], axis=1)


def bt(A):
    """Transpose the matrix dims of (n, m, B). XLA folds these transposes
    into the fused reduce of the following `bmm`."""
    return jnp.swapaxes(A, 0, 1)


def cholesky_bl(A):
    """Cholesky of an (n, n, B) SPD stack, unrolled over static n."""
    n = A.shape[0]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    rows = [
        jnp.stack([L[i][j] if j <= i else jnp.zeros_like(A[0, 0]) for j in range(n)])
        for i in range(n)
    ]
    return jnp.stack(rows)


def _solve_tril(L, b, vec: bool):
    n = L.shape[0]
    ys = []
    for i in range(n):
        s = b[i]
        for k in range(i):
            Lik = L[i, k] if vec else L[i, k][None, :]
            s = s - Lik * ys[k]
        Lii = L[i, i] if vec else L[i, i][None, :]
        ys.append(s / Lii)
    return jnp.stack(ys)


def cho_solve_bl(L, b):
    """Solve (L Lᵀ) x = b; b (n, B) vector or (n, m, B) matrix stack (solved
    for all m columns at once — row i of b broadcasts as (m, B))."""
    vec = b.ndim == 2
    y = _solve_tril(L, b, vec)
    return _solve_tril_T(L, y, vec)


def solve_spd_multi(A, rhs_list):
    """Solve A·X = RHS for an SPD (n, n, B) stack against several RHS at once
    via Gauss-Jordan row elimination on the augmented system.

    rhs_list: list of (n, B) or (n, m, B) arrays. Returns solutions in the
    same shapes. Row operations act on whole (n_aug, B) slabs: far fewer,
    wider ops than a scalar-unrolled Cholesky. No pivoting — callers pass a
    regularized SPD matrix.
    """
    n = A.shape[0]
    cols = [A]
    shapes = []
    for r in rhs_list:
        shapes.append(r.ndim)
        cols.append(r[:, None, :] if r.ndim == 2 else r)
    M = jnp.concatenate(cols, axis=1)  # (n, n_aug, B)
    for j in range(n):
        pivot = M[j, j]  # (B,)
        row_j = M[j] / pivot[None, :]  # (n_aug, B)
        factors = M[:, j]  # (n, B)
        M = M - factors[:, None, :] * row_j[None, :, :]
        # row write via static-slice concat instead of .at[j]
        # (dynamic_update_slice); skip zero-width end slices
        pieces = ([M[:j]] if j > 0 else []) + [row_j[None]] + (
            [M[j + 1 :]] if j + 1 < n else []
        )
        M = jnp.concatenate(pieces, axis=0)
    out = []
    ofs = n
    for r, nd in zip(rhs_list, shapes):
        width = 1 if nd == 2 else r.shape[1]
        sol = M[:, ofs : ofs + width]
        out.append(sol[:, 0] if nd == 2 else sol)
        ofs += width
    return out


def _solve_tril_T(L, y, vec: bool):
    """Solve Lᵀ x = y."""
    n = L.shape[0]
    xs = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            Lki = L[k, i] if vec else L[k, i][None, :]
            s = s - Lki * xs[k]
        Lii = L[i, i] if vec else L[i, i][None, :]
        xs[i] = s / Lii
    return jnp.stack(xs)


# ---------------------------------------------------------------------------
# Fleet problem / spec
# ---------------------------------------------------------------------------


class FleetModelSpec(NamedTuple):
    """Static fleet-native model description.

    f:  (x (nx,B), u (nu,B), params) -> xdot (nx,B)
    fj: (x, u, params) -> (nx, nx+nu, B) continuous Jacobian
    """

    nx: int
    nu: int
    f: Callable
    fj: Callable
    quat_idx: Optional[int] = None
    integrator: str = "midpoint"
    # Optional model-provided STRUCTURED error-state discrete Jacobian:
    # (x, x1, u, params, h) -> (Ae (ne, ne, B), Be (ne, nu, B)), exactly
    # equal to E(x1)ᵀ·discretize(fj)·E(x). When a model's continuous
    # Jacobian is sparse (the quat SRB's is ~85% structural zeros), the
    # block form skips the dense (nx, nx+nu, B) builds and 13-wide
    # contractions per knot — if the backward pass is bound by memory
    # bandwidth at fleet batch sizes, the dropped materializations are the
    # win (see models/srb.py quat_srb_error_discrete_jac_fleet).
    edj: Optional[Callable] = None
    # Optional finer decomposition (models/srb.py SrbEdjBlocks): the
    # sequential Riccati sweep consumes the raw blocks and writes every
    # Q-term product against the sparsity instead of dense 12-wide
    # contractions (riccati_step). The assoc-scan backend still needs the
    # dense Ae/Be (its combine works on full matrices) and uses `edj`.
    edj_blocks: Optional[Callable] = None

    @property
    def ne(self) -> int:
        return self.nx if self.quat_idx is None else self.nx - 1


class FleetProblem(NamedTuple):
    """Batch-last problem pytree. Shapes (B = fleet size):

    x0 (nx, B); x_ref (N+1, nx, B); u_ref (N+1, nu, B); Qd (nx, B) or (nx, 1);
    Rd (nu, ...); w (B,) or (1,); Cu (nc, nu, B); cb (nc, B); h scalar or (B,).
    """

    x0: jnp.ndarray
    x_ref: jnp.ndarray
    u_ref: jnp.ndarray
    Qd: jnp.ndarray
    Rd: jnp.ndarray
    w: jnp.ndarray
    Cu: jnp.ndarray
    cb: jnp.ndarray  # (nc, B) shared, or (N+1, nc, B) per-knot contact gating
    h: jnp.ndarray
    params: object
    us_init: jnp.ndarray
    Qdf: Optional[jnp.ndarray] = None  # terminal state weight (None -> Qd)
    lam_init: Optional[jnp.ndarray] = None  # (N, nc, B) dual warm start —
    # carrying the previous tick's multipliers across solves is the other
    # half of the real-time-iteration scheme (us_init carries the primals);
    # with both warm, ONE AL x ONE iLQR iteration per tick tracks in
    # closed loop (see tests) at a fraction of the cold-start budget


def cb_knots(cb: jnp.ndarray, n_knots: int) -> jnp.ndarray:
    """Normalize the constraint offset to per-knot (n_knots, nc, B): a shared
    (nc, B) cb broadcasts; a time-varying (N+1, nc, B) cb (per-knot contact
    schedule, the reference's ConvexMpc.cpp:82 TODO) is sliced to the stage
    knots."""
    if cb.ndim == 3:
        return cb[:n_knots]
    return jnp.broadcast_to(cb[None], (n_knots,) + cb.shape)


# ---------------------------------------------------------------------------
# Quaternion pieces (batch-last, quaternion components in dim 0)
# ---------------------------------------------------------------------------


def _quat_G_bl(q):
    """q (4, B) -> G(q) (4, 3, B)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    rows = [
        [-x, -y, -z],
        [w, -z, y],
        [z, w, -x],
        [-y, x, w],
    ]
    return jnp.stack([jnp.stack(r) for r in rows])


def _quat_err_bl(q, q_ref):
    """Cayley-chart attitude error (3, B) of q vs q_ref, both (4, B)."""
    # δq = q_ref⁻¹ ⊗ q
    w1, v1 = q_ref[0], -q_ref[1:]
    w2, v2 = q[0], q[1:]
    dw = w1 * w2 - jnp.sum(v1 * v2, axis=0)
    dv = w1 * v2 + w2 * v1 + jnp.cross(v1, v2, axis=0)
    return dv / dw


def _error_proj_bl(x, quat_idx, ne):
    """E(x): (nx, ne, B) = blkdiag(I_qi, G(q), I_rest), scatter-free.

    Built from stacked/concatenated blocks (never integer-array `.at[]`,
    which lowers to scatter ops).
    """
    nx = x.shape[0]
    B = x.shape[-1]
    dtype = x.dtype
    if quat_idx is None:
        return jnp.broadcast_to(_eye(nx, dtype)[..., None], (nx, nx, B))
    qi = quat_idx
    rest = nx - qi - 4

    def zeros(r, c):
        return jnp.zeros((r, c, B), dtype=dtype)

    top = jnp.concatenate(
        [
            jnp.broadcast_to(_eye(qi, dtype)[..., None], (qi, qi, B)),
            zeros(qi, ne - qi),
        ],
        axis=1,
    )
    G = jnp.broadcast_to(_quat_G_bl(x[qi : qi + 4]), (4, 3, B))
    mid = jnp.concatenate([zeros(4, qi), G, zeros(4, ne - qi - 3)], axis=1)
    blocks = [top, mid]
    if rest > 0:
        bot = jnp.concatenate(
            [
                zeros(rest, qi + 3),
                jnp.broadcast_to(_eye(rest, dtype)[..., None], (rest, rest, B)),
            ],
            axis=1,
        )
        blocks.append(bot)
    return jnp.concatenate(blocks, axis=0)


def _state_diff_bl(x, x_ref, quat_idx):
    if quat_idx is None:
        return x - x_ref
    qi = quat_idx
    phi = _quat_err_bl(x[qi : qi + 4], x_ref[qi : qi + 4])
    return jnp.concatenate([x[:qi] - x_ref[:qi], phi, x[qi + 4 :] - x_ref[qi + 4 :]])


# ---------------------------------------------------------------------------
# Discretization (batch-last)
# ---------------------------------------------------------------------------


def _fleet_step(spec: FleetModelSpec, x, u, params, h):
    if spec.integrator == "midpoint":
        xm = x + 0.5 * h * spec.f(x, u, params)
        return x + h * spec.f(xm, u, params)
    return x + h * spec.f(x, u, params)


def _fleet_discrete_jac(spec: FleetModelSpec, x, u, params, h):
    nx = spec.nx
    eye = _eye(nx, x.dtype)[..., None]
    if spec.integrator == "midpoint":
        J = spec.fj(x, u, params)
        A, Bm_ = J[:, :nx], J[:, nx:]
        xm = x + 0.5 * h * spec.f(x, u, params)
        Jm = spec.fj(xm, u, params)
        Am, Bm = Jm[:, :nx], Jm[:, nx:]
        Ad = eye + h * bmm(Am, eye + 0.5 * h * A)
        Bd = h * (0.5 * h * bmm(Am, Bm_) + Bm)
        return Ad, Bd
    J = spec.fj(x, u, params)
    return eye + h * J[:, :nx], h * J[:, nx:]


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


class FleetSolution(NamedTuple):
    xs: jnp.ndarray   # (N+1, nx, B)
    us: jnp.ndarray   # (N, nu, B)
    cost: jnp.ndarray  # (B,)
    iterations: jnp.ndarray
    lam: "object" = None  # (N, nc, B) final AL multipliers (dual warm start)


def _eye(n: int, dtype):
    """Identity built from iota comparisons, not `jnp.eye`; XLA
    constant-folds this form."""
    r = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return (r == c).astype(dtype)


def _att_diag_mask(qi: int, ne: int, dtype):
    """(ne, ne, 1) mask on the attitude-error diagonal — `lxx + mask * corr`
    instead of a serialized `.at[idx, idx].add` scatter."""
    r = jax.lax.broadcasted_iota(jnp.int32, (ne, ne), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (ne, ne), 1)
    m = (r == c) & (r >= qi) & (r < qi + 3)
    return m.astype(dtype)[..., None]


def stage_cost_terms(spec, x, u, x_ref, u_ref, prob):
    """Per-knot cost value (B,)."""
    qi = spec.quat_idx
    dx = x - x_ref
    val = 0.5 * jnp.sum(prob.Qd * dx * dx, axis=0)
    du = u - u_ref
    val = val + 0.5 * jnp.sum(prob.Rd * du * du, axis=0)
    if qi is not None:
        dot = jnp.sum(x[qi : qi + 4] * x_ref[qi : qi + 4], axis=0)
        val = val + prob.w * (1.0 - jnp.abs(dot))
    return val


def al_value(c, lam, rho):
    lam_bar = jnp.maximum(0.0, lam + rho * c)
    return (jnp.sum(lam_bar * lam_bar, axis=0) - jnp.sum(lam * lam, axis=0)) / (
        2.0 * rho
    )


def total_cost(spec, xs, us, prob, lam, rho):
    qi = spec.quat_idx

    def knot(k_x, k_u, k_xr, k_ur, k_lam, k_cb):
        c = bmv(prob.Cu, k_u) + k_cb
        return stage_cost_terms(spec, k_x, k_u, k_xr, k_ur, prob) + al_value(
            c, k_lam, rho
        )

    stage = jax.vmap(knot)(
        xs[:-1], us, prob.x_ref[:-1], prob.u_ref[:-1], lam,
        cb_knots(prob.cb, us.shape[0]),
    )
    kN = xs.shape[0] - 1
    dxN = xs[kN] - prob.x_ref[kN]
    Qdf = prob.Qd if prob.Qdf is None else prob.Qdf
    term = 0.5 * jnp.sum(Qdf * dxN * dxN, axis=0)
    if qi is not None:
        dot = jnp.sum(xs[kN][qi : qi + 4] * prob.x_ref[kN][qi : qi + 4], axis=0)
        term = term + prob.w * (1.0 - jnp.abs(dot))
    return jnp.sum(stage, axis=0) + term


def _state_expansion_structured(x, x_ref, Qd, w, qi, ne):
    """(lx (ne,B), lxx (ne,ne,B)) of the diagonal-Q + geodesic-attitude
    state cost, computed BLOCKWISE — exactly Eᵀg and Eᵀdiag(Qd)E + corr·M
    without materializing the (nx, ne, B) projection E: with
    E = blkdiag(I, G(q), I), lxx is block-diagonal
    [diag(Qd_p) ⊕ (G(q)ᵀdiag(Qd_q)G(q) + corr·I₃) ⊕ diag(Qd_rest)].
    The dense path built E and ran two 13-wide contractions per knot; at
    fleet batch sizes those are mostly device-memory traffic."""
    dtype = x.dtype
    B = x.shape[-1]
    g = Qd * (x - x_ref)  # (nx, B)
    if qi is None:
        lx = g
        lxx = _eye(x.shape[0], dtype)[..., None] * Qd[None, :, :]
        return lx, jnp.broadcast_to(lxx, (ne, ne, B))
    q = x[qi : qi + 4]
    q_ref = x_ref[qi : qi + 4]
    dot = jnp.sum(q * q_ref, axis=0)
    s = jnp.sign(dot)
    g_q = g[qi : qi + 4] - w * s * q_ref
    corr = -jnp.sum(q * g_q, axis=0)
    G = _quat_G_bl(q)  # (4, 3, B)
    # lx = Eᵀ g, blockwise
    mtv = lambda A_, v_: jnp.sum(A_ * v_[:, None, :], axis=0)  # Aᵀ v
    lx = jnp.concatenate([g[:qi], mtv(G, g_q), g[qi + 4 :]], axis=0)
    # attitude block: Gᵀ diag(Qd_q) G + corr·I₃
    GQ = Qd[qi : qi + 4][:, None, :] * G
    att = jnp.sum(G[:, :, None, :] * GQ[:, None, :, :], axis=0)
    r3 = jax.lax.broadcasted_iota(jnp.int32, (3, 3), 0)
    c3 = jax.lax.broadcasted_iota(jnp.int32, (3, 3), 1)
    eye3 = (r3 == c3).astype(dtype)[..., None]
    att = att + eye3 * corr
    # assemble block-diagonal lxx (ne, ne, B)
    rest = ne - qi - 3

    def diag_blk(wd, n):
        return jnp.broadcast_to(_eye(n, dtype)[..., None] * wd[None, :, :],
                                (n, n, B))

    def z(r, c):
        return jnp.zeros((r, c, B), dtype=dtype)

    top = jnp.concatenate(
        [diag_blk(jnp.broadcast_to(Qd[:qi], (qi, B)), qi), z(qi, ne - qi)],
        axis=1,
    )
    mid = jnp.concatenate(
        [z(3, qi), jnp.broadcast_to(att, (3, 3, B)), z(3, rest)], axis=1
    )
    blocks = [top, mid]
    if rest > 0:
        bot = jnp.concatenate(
            [z(rest, qi + 3),
             diag_blk(jnp.broadcast_to(Qd[qi + 4 :], (rest, B)), rest)],
            axis=1,
        )
        blocks.append(bot)
    return lx, jnp.concatenate(blocks, axis=0)


def cost_expansion(spec, x, u, x_ref, u_ref, lam, rho, prob, cb):
    qi, ne = spec.quat_idx, spec.ne
    lx, lxx = _state_expansion_structured(x, x_ref, prob.Qd, prob.w, qi, ne)
    lu = prob.Rd * (u - u_ref)
    luu = _eye(spec.nu, x.dtype)[..., None] * prob.Rd[None, :, :]
    c = bmv(prob.Cu, u) + cb
    lam_bar = jnp.maximum(0.0, lam + rho * c)
    active = ((lam + rho * c) >= 0.0).astype(x.dtype)
    lu = lu + bmv(bt(prob.Cu), lam_bar)
    luu = luu + rho * bmm(bt(prob.Cu) * active[None, :, :], prob.Cu)
    return lx, lxx, lu, luu


def terminal_expansion(spec, xN, prob):
    qi, ne = spec.quat_idx, spec.ne
    kN = prob.x_ref.shape[0] - 1
    Qdf = prob.Qd if prob.Qdf is None else prob.Qdf
    return _state_expansion_structured(xN, prob.x_ref[kN], Qdf, prob.w, qi, ne)


def error_discrete_jac(spec, x, x1, u, prob):
    """(Ae, Be): error-state discrete Jacobians at a knot — the model's
    structured form when provided (spec.edj), else the generic dense path
    (discretize fj, then project through E(x)/E(x1))."""
    if spec.edj is not None:
        return spec.edj(x, x1, u, prob.params, prob.h)
    qi, ne = spec.quat_idx, spec.ne
    Ad, Bd = _fleet_discrete_jac(spec, x, u, prob.params, prob.h)
    E0 = _error_proj_bl(x, qi, ne)
    E1 = _error_proj_bl(x1, qi, ne)
    return bmm(bt(E1), bmm(Ad, E0)), bmm(bt(E1), Bd)


def _structured_q_terms(blocks, Vx, Vxx, lx, lxx, lu, luu):
    """Q-expansion products written against the SRB error-state block
    sparsity (models/srb.py `SrbEdjBlocks`):

        Ae = [[I,0,h·I,0],[0,Aφφ,0,Aφω],[0,0,I,0],[0,0,0,I]]
        Be = [[s_p/m·(I…I)],[Bφ],[s_v/m·(I…I)],[s_w·Bω]]

    so e.g. Aeᵀ·Vxx = [Vp; Aφφᵀ·Vφ; h·Vp+Vv; Aφωᵀ·Vφ+Vω] — 2 tiny 3-wide
    contractions instead of a dense 12³ one. ~6× fewer flops and ~6× fewer
    device-memory bytes through the dominant reduce_sum chain."""
    h, sp, sv, sw = blocks.h, blocks.s_p, blocks.s_v, blocks.s_w
    inv_m = blocks.inv_m
    Aff, Afw, Bf, Bw = blocks.A_phi, blocks.A_pw, blocks.B_phi, blocks.Bw
    n_feet = Bw.shape[1] // 3
    mtm = lambda A_, B_: jnp.sum(A_[:, :, None, :] * B_[:, None, :, :], axis=0)
    mtv = lambda A_, v_: jnp.sum(A_ * v_[:, None, :], axis=0)

    Vp, Vf, Vv, Vw = Vxx[0:3], Vxx[3:6], Vxx[6:9], Vxx[9:12]
    AtV = jnp.concatenate(
        [Vp, mtm(Aff, Vf), h * Vp + Vv, mtm(Afw, Vf) + Vw], axis=0
    )
    vp, vf, vv, vw = Vx[0:3], Vx[3:6], Vx[6:9], Vx[9:12]
    Qx = lx + jnp.concatenate(
        [vp, mtv(Aff, vf), h * vp + vv, mtv(Afw, vf) + vw], axis=0
    )
    M0, M1, M2, M3 = AtV[:, 0:3], AtV[:, 3:6], AtV[:, 6:9], AtV[:, 9:12]
    Qxx = lxx + jnp.concatenate(
        [M0, bmm(M1, Aff), h * M0 + M2, bmm(M1, Afw) + M3], axis=1
    )
    BtV = (
        jnp.tile((sp * Vp + sv * Vv) * inv_m, (n_feet, 1, 1))
        + mtm(Bf, Vf) + sw * mtm(Bw, Vw)
    )
    Qu = lu + (
        jnp.tile((sp * vp + sv * vv) * inv_m, (n_feet, 1))
        + mtv(Bf, vf) + sw * mtv(Bw, vw)
    )
    N0, N1, N2, N3 = BtV[:, 0:3], BtV[:, 3:6], BtV[:, 6:9], BtV[:, 9:12]
    Quu = luu + (
        jnp.tile((sp * N0 + sv * N2) * inv_m, (1, n_feet, 1))
        + bmm(N1, Bf) + sw * bmm(N3, Bw)
    )
    Qux = jnp.concatenate(
        [N0, bmm(N1, Aff), h * N0 + N2, bmm(N1, Afw) + N3], axis=1
    )
    return Qx, Qu, Qxx, Quu, Qux


def riccati_step(spec, prob, carry, x, x1, u, x_ref, u_ref, k_lam, k_cb, rho, reg):
    """One fused expansion + Riccati knot update. carry = (Vx, Vxx)."""
    qi, ne = spec.quat_idx, spec.ne
    eye_u = _eye(spec.nu, x.dtype)[..., None]
    Vx, Vxx = carry
    lx, lxx, lu, luu = cost_expansion(
        spec, x, u, x_ref, u_ref, k_lam, rho, prob, k_cb
    )
    if spec.edj_blocks is not None:
        blocks = spec.edj_blocks(x, x1, u, prob.params, prob.h)
        Qx, Qu, Qxx, Quu, Qux = _structured_q_terms(
            blocks, Vx, Vxx, lx, lxx, lu, luu
        )
    else:
        A, B_ = error_discrete_jac(spec, x, x1, u, prob)
        AtV = bmm(bt(A), Vxx)
        BtV = bmm(bt(B_), Vxx)
        Qx = lx + bmv(bt(A), Vx)
        Qu = lu + bmv(bt(B_), Vx)
        Qxx = lxx + bmm(AtV, A)
        Quu = luu + bmm(BtV, B_)
        Qux = bmm(BtV, A)
    with jax.named_scope("gj_solve"):
        d, K = solve_spd_multi(Quu + reg * eye_u, [Qu, Qux])
    d, K = -d, -K
    KtQuu = bmm(bt(K), Quu)
    Vx_n = Qx + bmv(KtQuu, d) + bmv(bt(K), Qu) + bmv(bt(Qux), d)
    Vxx_n = Qxx + bmm(KtQuu, K) + bmm(bt(K), Qux) + bmm(bt(Qux), K)
    Vxx_n = 0.5 * (Vxx_n + bt(Vxx_n))
    dV1 = jnp.sum(d * Qu, axis=0)
    dV2 = 0.5 * jnp.sum(d * bmv(Quu, d), axis=0)
    return (Vx_n, Vxx_n), (K, d, dV1, dV2, jnp.max(jnp.abs(Qu), axis=0))


def riccati_backward(spec, prob, xs, us, lam, rho, reg, unroll: bool = False):
    """Fused expansion + Riccati sweep: the per-knot dynamics/cost expansions
    are computed INSIDE the reverse scan step, so the (N, ne, ne, B) stacks
    never round-trip through device memory. `unroll=True` replaces the scan
    with a Python loop (the FLOP-counting compile in bench.py)."""
    lxN, lxxN = terminal_expansion(spec, xs[xs.shape[0] - 1], prob)
    cbs = cb_knots(prob.cb, us.shape[0])
    if unroll:
        N = us.shape[0]
        carry = (lxN, lxxN)
        Ks, ds, dV1s, dV2s, gs = [None] * N, [None] * N, [], [], []
        for k in reversed(range(N)):
            carry, (K, d, dV1, dV2, g) = riccati_step(
                spec, prob, carry, xs[k], xs[k + 1], us[k],
                prob.x_ref[k], prob.u_ref[k], lam[k], cbs[k], rho, reg,
            )
            Ks[k], ds[k] = K, d
            dV1s.append(dV1)
            dV2s.append(dV2)
            gs.append(g)
        return (
            jnp.stack(Ks),
            jnp.stack(ds),
            sum(dV1s),
            sum(dV2s),
            jnp.max(jnp.stack(gs), axis=0),
        )

    def step(carry, inp):
        x, x1, u, x_ref, u_ref, k_lam, k_cb = inp
        return riccati_step(
            spec, prob, carry, x, x1, u, x_ref, u_ref, k_lam, k_cb, rho, reg
        )

    # The BACKWARD knot scan runs fully UNROLLED (N static, 10-30): the
    # rolled while-loop's carry double-buffering + dynamic-update-slice
    # output stacking move extra bytes at fleet batch sizes. The forward
    # ROLLOUT scans stay rolled: their alpha-vmapped bodies are cheap and
    # an unrolled form defeats XLA's cross-knot fusion there. Iteration-
    # level scans (AL, iLQR) stay rolled: their bodies are the whole knot
    # program; unrolling them 10× explodes compile time for no bookkeeping
    # win. On the H100 these choices are unmeasured.
    with jax.named_scope("riccati_backward"):
        (_, _), (Ks, ds, dV1s, dV2s, gs) = jax.lax.scan(
            step,
            (lxN, lxxN),
            (xs[:-1], xs[1:], us, prob.x_ref[:-1], prob.u_ref[:-1], lam, cbs),
            reverse=True,
            unroll=True,
        )
    return Ks, ds, jnp.sum(dV1s, axis=0), jnp.sum(dV2s, axis=0), jnp.max(gs, axis=0)


def knot_expansions(spec, prob, xs, us, lam, rho):
    """All per-knot dynamics/cost expansions at once (vmapped over knots):
    (As, Bs, lxs, lxxs, lus, luus). The associative-scan backward pass
    (solver/parallel_riccati.py) builds its one-step elements from them."""
    qi, ne = spec.quat_idx, spec.ne
    kN = xs.shape[0] - 1

    def knot(x, x1, u, x_ref, u_ref, k_lam, k_cb):
        A, B_ = error_discrete_jac(spec, x, x1, u, prob)
        lx, lxx, lu, luu = cost_expansion(
            spec, x, u, x_ref, u_ref, k_lam, rho, prob, k_cb
        )
        return A, B_, lx, lxx, lu, luu

    return jax.vmap(knot)(
        xs[:kN], xs[1:], us, prob.x_ref[:kN], prob.u_ref[:kN], lam,
        cb_knots(prob.cb, us.shape[0]),
    )


def rollout(spec, prob, xs_bar, us_bar, Ks, ds, alpha, unroll: bool = False):
    """alpha: (B,) per-scenario step length."""
    qi = spec.quat_idx

    def step(x, inp):
        x_bar, u_bar, K, d = inp
        dx = _state_diff_bl(x, x_bar, qi)
        u = u_bar + alpha * d + bmv(K, dx)
        return _fleet_step(spec, x, u, prob.params, prob.h), (x, u)

    xN, (xs, us) = jax.lax.scan(
        step, xs_bar[0], (xs_bar[:-1], us_bar, Ks, ds), unroll=unroll
    )
    return jnp.concatenate([xs, xN[None]], axis=0), us


def make_fleet_solver(
    spec: FleetModelSpec,
    opts: SolverOptions = SolverOptions(),
    backend: str = "auto",
    unroll_scans: bool = False,
):
    """Returns solve(prob: FleetProblem) -> FleetSolution, fully batch-last.

    backend: "xla" | "assoc" | "auto".
    The large-batch path is the fixture-exact XLA sweep: the mul+sum
    contraction form lets XLA fuse the whole backward pass. "assoc"
    replaces the sequential Riccati recursion with the O(log N)
    associative-scan backward pass (solver/parallel_riccati.py) — the
    horizon-parallel variant for long horizons / small batches. "auto"
    routes the single-robot case (B == 1, the 200 Hz latency contract) to
    assoc and every fleet to the sequential sweep — assoc's different op
    order breaks bit-level fleet==single parity, so fleets stay on the
    fixture-exact path (B is static under jit; the choice costs nothing at
    runtime). Where the crossover lies on the H100 is unmeasured.

    ``unroll_scans=True`` fully unrolls every horizon/iteration lax.scan.
    Runtime-irrelevant (same math, bigger program); it exists for FLOP
    accounting: XLA's compiled cost_analysis counts a scan body ONCE
    regardless of trip count, so a rolled program under-counts the solve by
    ~the iteration product. bench.py compiles an unrolled twin purely to
    read the true flops/solve (see bench._flops_per_solve).
    """
    qi = spec.quat_idx
    ne = spec.ne
    _u = unroll_scans  # shorthand: lax.scan(unroll=) takes bool (full) too

    def backward(prob, xs, us, lam, rho, reg, B):
        if backend == "assoc" or (backend == "auto" and B == 1):
            from quaternion_mpc_tpu.solver import parallel_riccati

            return parallel_riccati.parallel_backward(
                spec, prob, xs, us, lam, rho, reg
            )
        return riccati_backward(spec, prob, xs, us, lam, rho, reg, unroll=_u)

    def solve(prob: FleetProblem) -> FleetSolution:
        dtype = prob.x0.dtype
        B = prob.x0.shape[-1]
        N = prob.us_init.shape[0]
        nc = prob.cb.shape[-2]

        def init_step(x, u):
            return _fleet_step(spec, x, u, prob.params, prob.h), x

        xN0, xs0 = jax.lax.scan(init_step, prob.x0, prob.us_init, unroll=_u)
        xs = jnp.concatenate([xs0, xN0[None]], axis=0)
        us = prob.us_init

        lam = (
            jnp.zeros((N, nc, B), dtype=dtype)
            if prob.lam_init is None else prob.lam_init
        )
        rho0 = jnp.asarray(opts.penalty_initial, dtype)
        reg0 = jnp.full((B,), opts.reg_initial, dtype=dtype)

        # Backtracking alphas 1, 1/2, ... evaluated in PARALLEL (a wider
        # batch), not serially: the reference-style while_loop backtracker
        # runs the fleet to the WORST scenario's try count (any straggler
        # serializes 4096 scenarios through up to 12 full rollouts). One
        # K-wide rollout pass selects, per scenario, the first (largest)
        # alpha passing Armijo — identical accept semantics to serial
        # backtracking with K tries (the rollouts are vmapped, so extra
        # alphas are batch width, not serial passes — honor the full
        # max_linesearch budget).
        n_alpha = opts.max_linesearch
        alphas = jnp.asarray(0.5 ** np.arange(n_alpha), dtype)

        def ilqr_iteration(state):
            xs, us, lam, rho, reg, J, done, n_iter = state
            Ks, ds, dV1, dV2, gnorm = backward(prob, xs, us, lam, rho, reg, B)

            def roll_one(alpha):
                xs_a, us_a = rollout(
                    spec, prob, xs, us, Ks, ds, alpha * jnp.ones((B,), dtype),
                    unroll=_u,
                )
                return xs_a, us_a, total_cost(spec, xs_a, us_a, prob, lam, rho)

            with jax.named_scope("linesearch_rollouts"):
                xs_m, us_m, J_m = jax.vmap(roll_one)(alphas)  # (K,...), J_m (K,B)
            expected = -(alphas[:, None] * dV1[None, :] + (alphas**2)[:, None] * dV2[None, :])
            ok = jnp.where(
                expected > 0.0,
                (J[None, :] - J_m) / jnp.maximum(expected, 1e-30) > 1e-4,
                J_m < J[None, :] + 1e-12,
            )
            ok = ok & jnp.isfinite(J_m)
            accepted = jnp.any(ok, axis=0)
            first = jnp.argmax(ok, axis=0)  # first True along descending alphas
            sel = (jnp.arange(n_alpha)[:, None] == first[None, :]) & ok
            # NaN-safe select: an unselected alpha's rollout may hold Inf/NaN
            # states (the divergence case backtracking exists for); a 0/1
            # weighted SUM would turn 0·Inf into NaN and silently discard the
            # accepted step, so mask with `where` before reducing.
            with jax.named_scope("ls_select"):
                selm = sel[:, None, None, :]
                xs_ls = jnp.sum(jnp.where(selm, xs_m, 0.0), axis=0)
                us_ls = jnp.sum(jnp.where(selm, us_m, 0.0), axis=0)
            J_ls = jnp.sum(jnp.where(sel, J_m, 0.0), axis=0) + jnp.where(
                accepted, 0.0, J
            )

            improved = accepted & (J_ls < J)
            take = improved & ~done
            xs = jnp.where(take[None, None, :], xs_ls, xs)
            us = jnp.where(take[None, None, :], us_ls, us)
            J_out = jnp.where(take, J_ls, J)
            reg = jnp.where(
                improved,
                jnp.maximum(reg / opts.reg_scale_up, opts.reg_initial),
                jnp.minimum(reg * opts.reg_scale_up, opts.reg_max),
            )
            conv = (jnp.abs(J - J_out) < opts.cost_tol) | (gnorm < opts.grad_tol)
            done = done | conv | ~accepted
            return (xs, us, lam, rho, reg, J_out, done, n_iter + 1)

        def al_body(carry, _):
            xs, us, lam, rho, reg, n_total = carry
            J = total_cost(spec, xs, us, prob, lam, rho)
            state = (xs, us, lam, rho, reg, J, jnp.zeros((B,), dtype=bool), n_total)
            state, _ = jax.lax.scan(
                lambda s, _: (ilqr_iteration(s), None),
                state,
                None,
                length=opts.ilqr_iterations,
                unroll=_u,
            )
            xs, us, lam, rho, reg, J, _, n_total = state

            def cvals_k(u_k, lam_k, cb_k):
                return jnp.maximum(0.0, lam_k + rho * (bmv(prob.Cu, u_k) + cb_k))

            lam = jax.vmap(cvals_k)(us, lam, cb_knots(prob.cb, N))
            rho = rho * opts.penalty_scaling
            return (xs, us, lam, rho, reg, n_total), None

        # backward-pass reg enters as (B,) broadcast against (nu, nu, B)
        carry = (xs, us, lam, rho0, reg0, jnp.asarray(0, jnp.int32))
        carry, _ = jax.lax.scan(
            al_body, carry, None, length=opts.al_iterations, unroll=_u
        )
        xs, us, lam, rho, reg, n_total = carry

        final_cost = total_cost(
            spec, xs, us, prob, jnp.zeros_like(lam), jnp.asarray(1e-30, dtype)
        )
        return FleetSolution(
            xs=xs, us=us, cost=final_cost, iterations=n_total, lam=lam
        )

    return solve
