"""Pallas kernel (Triton route): fused FMPC condensed-Riccati backward.

One program runs the whole condensed primal-dual Riccati recursion
(reference ``FmpcSolver.hpp:524-665``: (s, nu) condensation via the nu/s
diagonal, F/H/G assembly, the KKT block factorization LLT(G) with the LU
fallback, and the (s_vec, P) value recursion) for a block of batch lanes.
The value-function carry (s_vec, P) stays in registers across all N
stages; per-stage coefficients are loaded from device memory and per-stage
outputs (k, K, s_vec, P) are stored back as each stage completes.  The
stacked XLA version (``solvers/fmpc.py::_backward_bm``) is a ``lax.scan``
of small kernels per stage.  Scaffolding is shared with the other lane
kernels (``kernels/lane_kernel.py``).

The slack/dual condensation scalings ``nu_s = nu/s`` and
``tilde = (nu/s)*g_bar - nu + eps/s`` are precomputed OUTSIDE the kernel
(elementwise XLA) so the kernel reads 12 per-stage quantities and needs no
per-lane barrier input.

Layout contract (identical to ``_backward_bm``): batch-minor inputs;
outputs ks [N, nu, B], Ks [N, nu, nx, B], svecs [N, nx, B],
Ps [N, nx, nx, B], ok [B].  Numerical semantics match ``_backward_bm``
(same unrolled Cholesky with the Eigen-LLT pivot>0 failure rule; same
partial-pivot Gauss-Jordan fallback as ``parallel_riccati._inv_bl`` when
``break_if_llt_fails`` is off); parity is tested in
tests/test_pallas_kernels.py.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from nmpc_tpu.kernels.ddp_backward_pallas import (
    _chol_solve_t,
    _chol_t,
    _mm_t,
    _mv_t,
    _transpose_t,
    load_mat,
    load_vec,
)
from nmpc_tpu.kernels.lane_kernel import lane_call


def _inv_t(A, n):
    """Unrolled Gauss-Jordan inverse with partial pivoting on tile-matrices
    (mirrors ``parallel_riccati._inv_bl`` lane-for-lane, so the LU-fallback
    gains match the stacked XLA path bit-for-bit in spirit)."""
    a = [[A[i][j] for j in range(n)] for i in range(n)]
    zeros = jnp.zeros_like(A[0][0])
    ones = jnp.ones_like(A[0][0])
    inv = [[ones if i == j else zeros for j in range(n)] for i in range(n)]
    for col in range(n):
        for r in range(col + 1, n):
            swap = jnp.abs(a[r][col]) > jnp.abs(a[col][col])
            for j in range(n):
                a[col][j], a[r][j] = (jnp.where(swap, a[r][j], a[col][j]),
                                      jnp.where(swap, a[col][j], a[r][j]))
                inv[col][j], inv[r][j] = (
                    jnp.where(swap, inv[r][j], inv[col][j]),
                    jnp.where(swap, inv[col][j], inv[r][j]))
        piv = a[col][col]
        ipiv = 1.0 / jnp.where(piv == 0, 1e-30, piv)
        for j in range(n):
            a[col][j] = a[col][j] * ipiv
            inv[col][j] = inv[col][j] * ipiv
        for r in range(n):
            if r == col:
                continue
            f = a[r][col]
            for j in range(n):
                a[r][j] = a[r][j] - f * a[col][j]
                inv[r][j] = inv[r][j] - f * inv[col][j]
    return inv


def _fmpc_stage(dt, break_if_llt_fails, nx, nu, ng, fields, carry):
    """One condensed-Riccati stage on loaded tile-fields.  Returns
    (new_carry, k, K, s_new, P_sym).
    Mirrors ``FmpcSolver.hpp:551-637``: (s, nu) condensation, F/H/G
    assembly, LLT(G) + Gauss-Jordan LU fallback, value recursion."""
    s_vec, P, ok = carry
    A, Bm = fields["A"], fields["B"]
    C, D = fields["C"], fields["D"]
    Lxx, Luu, Lxu = fields["Lxx"], fields["Luu"], fields["Lxu"]
    xb, Lxb, Lub = fields["xb"], fields["Lxb"], fields["Lub"]
    nu_s, tilde = fields["nu_s"], fields["tilde"]

    # (s, nu) condensation (FmpcSolver.hpp:572-579)
    CT = _transpose_t(C, ng, nx)
    DT = _transpose_t(D, ng, nu)
    nsC = [[nu_s[a] * C[a][b] for b in range(nx)] for a in range(ng)]
    nsD = [[nu_s[a] * D[a][b] for b in range(nu)] for a in range(ng)]
    M = _mm_t(CT, nsC, nx, ng, nx)
    Qxx = [[dt * Lxx[a][b] + M[a][b] for b in range(nx)] for a in range(nx)]
    M = _mm_t(DT, nsD, nu, ng, nu)
    Quu = [[dt * Luu[a][b] + M[a][b] for b in range(nu)] for a in range(nu)]
    M = _mm_t(CT, nsD, nx, ng, nu)
    Qxu = [[dt * Lxu[a][b] + M[a][b] for b in range(nu)] for a in range(nx)]
    t = _mv_t(CT, tilde, nx, ng)
    Lx_t = [Lxb[a] + t[a] for a in range(nx)]
    t = _mv_t(DT, tilde, nu, ng)
    Lu_t = [Lub[a] + t[a] for a in range(nu)]

    # F/H/G assembly (FmpcSolver.hpp:581-583)
    AT = _transpose_t(A, nx, nx)
    BT = _transpose_t(Bm, nx, nu)
    PA = _mm_t(P, A, nx, nx, nx)
    PB = _mm_t(P, Bm, nx, nx, nu)
    M = _mm_t(AT, PA, nx, nx, nx)
    F = [[Qxx[a][b] + M[a][b] for b in range(nx)] for a in range(nx)]
    M = _mm_t(AT, PB, nx, nx, nu)
    H = [[Qxu[a][b] + M[a][b] for b in range(nu)] for a in range(nx)]
    M = _mm_t(BT, PB, nu, nx, nu)
    G = [[Quu[a][b] + M[a][b] for b in range(nu)] for a in range(nu)]

    # KKT block factorization: LLT(G) + LU fallback (FmpcSolver.hpp:594-618)
    Pxb = _mv_t(P, xb, nx, nx)
    rhs = _mv_t(BT, [Pxb[a] - s_vec[a] for a in range(nx)], nu, nx)
    rhs_k = [rhs[a] + Lu_t[a] for a in range(nu)]
    HT = _transpose_t(H, nx, nu)
    L, pd = _chol_t(G, nu)
    k_ch = [-v[0] for v in _chol_solve_t(L, [[r] for r in rhs_k], nu, 1)]
    Ksol = _chol_solve_t(L, HT, nu, nx)
    K_ch = [[-Ksol[a][b] for b in range(nx)] for a in range(nu)]
    if break_if_llt_fails:
        k, K = k_ch, K_ch
        ok = ok * pd
    else:
        Ginv = _inv_t(G, nu)
        k_lu = [-v for v in _mv_t(Ginv, rhs_k, nu, nu)]
        KM = _mm_t(Ginv, HT, nu, nu, nx)
        k = [jnp.where(pd > 0, k_ch[a], k_lu[a]) for a in range(nu)]
        K = [[jnp.where(pd > 0, K_ch[a][b], -KM[a][b])
              for b in range(nx)] for a in range(nu)]

    # value recursion (FmpcSolver.hpp:633-637)
    sMx = [s_vec[a] - Pxb[a] for a in range(nx)]
    t1 = _mv_t(AT, sMx, nx, nx)
    t2 = _mv_t(H, k, nx, nu)
    s_new = [t1[a] - Lx_t[a] - t2[a] for a in range(nx)]
    GK = _mm_t(G, K, nu, nu, nx)
    KT = _transpose_t(K, nu, nx)
    T1 = _mm_t(KT, GK, nx, nu, nx)
    P_new = [[F[a][b] - T1[a][b] for b in range(nx)] for a in range(nx)]
    P_sym = [[0.5 * (P_new[a][b] + P_new[b][a]) for b in range(nx)]
             for a in range(nx)]

    return (s_new, P_sym, ok), k, K, s_new, P_sym


_IN_FIELDS = ("A", "B", "C", "D", "Lxx", "Luu", "Lxu",
              "xb", "Lxb", "Lub", "nu_s", "tilde")


def backward_fmpc_pallas(problem, config, co, ss, nus, gms, barrier_eps):
    """Drop-in for ``solvers.fmpc._backward_bm`` (same signature and
    batch-minor layout, any B) backed by the fused kernel.  Requires
    ng >= 1.  Returns (ks, Ks, ss_all [N+1], Ps_all [N+1], ok_pd, finite).
    """
    N, ng = co.C.shape[0], co.C.shape[1]
    nx = co.A.shape[1]
    nu = co.B.shape[2]
    B = barrier_eps.shape[0]
    dtype = co.A.dtype
    assert ng >= 1
    dt = float(problem.dt)
    break_if_llt_fails = bool(config.break_if_llt_fails)

    # condensation scalings, precomputed (elementwise; XLA fuses these)
    gm_e = gms[:, :, None]
    nu_s = jnp.where(gm_e > 0, nus / ss, 0.0)
    tilde = jnp.where(
        gm_e > 0, nu_s * co.g_bar - nus + barrier_eps[None, None, :] / ss, 0.0)

    s_T = -co.Lx_bar_term
    P_T = co.Lxx_term

    shapes = {"A": (nx, nx), "B": (nx, nu), "C": (ng, nx), "D": (ng, nu),
              "Lxx": (nx, nx), "Luu": (nu, nu), "Lxu": (nx, nu),
              "xb": (nx,), "Lxb": (nx,), "Lub": (nu,), "nu_s": (ng,),
              "tilde": (ng,)}
    nf = len(_IN_FIELDS)

    def kernel(*refs):
        fr = dict(zip(_IN_FIELDS, refs[:nf]))
        sT_ref, PT_ref, ks_ref, Ks_ref, sv_ref, Ps_ref, ok_ref = refs[nf:]
        s_vec = [sT_ref[a] for a in range(nx)]
        P = [[PT_ref[a, b] for b in range(nx)] for a in range(nx)]

        def body(j, carry):
            i = N - 1 - j
            fields = {}
            for n in _IN_FIELDS:
                s = shapes[n]
                fields[n] = (load_mat(fr[n], i, *s) if len(s) == 2
                             else load_vec(fr[n], i, s[0]))
            new_carry, k, K, s_new, P_sym = _fmpc_stage(
                dt, break_if_llt_fails, nx, nu, ng, fields, carry)
            for a in range(nu):
                ks_ref[i, a] = k[a]
                for b in range(nx):
                    Ks_ref[i, a, b] = K[a][b]
            for a in range(nx):
                sv_ref[i, a] = s_new[a]
                for b in range(nx):
                    Ps_ref[i, a, b] = P_sym[a][b]
            return new_carry

        _, _, ok = lax.fori_loop(0, N, body,
                                 (s_vec, P, jnp.ones_like(s_vec[0])))
        ok_ref[...] = ok

    ks, Ks, svecs, Ps, okf = lane_call(
        kernel, name="fmpc_backward",
        inputs=[co.A, co.B, co.C, co.D, co.Lxx, co.Luu, co.Lxu, co.x_bar,
                co.Lx_bar, co.Lu_bar, nu_s, tilde, s_T, P_T],
        out_shapes=[((N, nu), dtype), ((N, nu, nx), dtype),
                    ((N, nx), dtype), ((N, nx, nx), dtype),
                    ((), jnp.float32)])
    ok = okf > 0.5

    ss_all = jnp.concatenate([svecs, s_T[None]], axis=0)
    Ps_all = jnp.concatenate([Ps, P_T[None]], axis=0)

    finite = jnp.ones((B,), dtype=bool)
    if config.check_nan:
        def fin(a):
            return jnp.all(jnp.isfinite(a), axis=tuple(range(a.ndim - 1)))
        finite = fin(ks) & fin(Ks) & fin(ss_all) & fin(Ps_all)
    return (ks, Ks, ss_all, Ps_all, ok, finite)
