"""FMPC solver: direct multiple shooting + primal-dual interior point +
stagewise Riccati recursion, batched in XLA.

Algorithmic equivalent of the reference ``nmpc_fmpc::FmpcSolver``
(``nmpc_fmpc/include/nmpc_fmpc/FmpcSolver.hpp``; Katayama PhD thesis §2.2):

  * linearized-KKT coefficients A,B,C,D,Lx̄,Lū,x̄,ḡ per stage
    (``FmpcSolver.hpp:401-440``),
  * barrier update eps = clamp(sigma * avg(s'nu)) (``:377-399``),
  * KKT-error termination with max(s∘nu - eps, 0) complementarity residual
    (``:443-448, 495-521``),
  * condensed backward Riccati eliminating (s, nu) through the nu/s diagonal
    (``:524-665``), with the LDLT -> FullPivLU robustness fallback
    (``:594-618``),
  * forward recursion for (Δx, Δu, Δλ, Δs, Δν) (``:667-708``),
  * fraction-to-boundary step sizes (``:713-750``) and optional l1-merit
    Armijo line search (``:752-793, 836-982``),
  * NaN/Inf detection on coefficients and deltas (``:10-18, 649-662``).

Batched redesign: coefficients are one vmapped autodiff sweep; the Riccati
recursion is a ``lax.scan``; the PDIP iteration loop is a ``lax.while_loop``
with per-lane ``FmpcStatus`` (a diverging lane cannot abort a batch);
time-varying input/inequality dimensions are static padding + masks
(``FmpcProblem.h:75-86``): masked inequality rows are pinned to
g = -1, s = 1, nu = 0 with zeroed Jacobian rows, which makes them exact
no-ops in every sum, product, and step-size rule.

Note on the reference's negativity clamp (``FmpcSolver.hpp:813-829``): it
clamps with ``std::numeric_limits<double>::lowest()`` — i.e. a no-op — so
slightly-negative s/nu after a full step are *kept*, only warned about.  We
reproduce that behavior (no clamp) for parity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from nmpc_tpu.core.problem import Problem
from nmpc_tpu.kernels.linalg import cho_solve_small, cholesky_small, lu_solve_small
from nmpc_tpu.utils.precision import full_precision
from nmpc_tpu.core.types import (
    FmpcConfig,
    FmpcResult,
    FmpcStatus,
    FmpcTrace,
    FmpcVariable,
)

_BARRIER_EPS_INIT = 1e-4   # FmpcSolver.h:414
_BARRIER_EPS_MIN = 1e-8    # FmpcSolver.hpp:396
_BARRIER_EPS_MAX = 1e6     # FmpcSolver.hpp:397
_SIGMA = 0.5               # FmpcSolver.hpp:392
_FTB_MARGIN = 0.995        # fraction-to-boundary margin, FmpcSolver.hpp:719


class _Coeffs(NamedTuple):
    A: jnp.ndarray       # [N, nx, nx]
    B: jnp.ndarray       # [N, nx, nu]
    C: jnp.ndarray       # [N, ng, nx]
    D: jnp.ndarray       # [N, ng, nu]
    Lx: jnp.ndarray      # [N, nx]
    Lu: jnp.ndarray      # [N, nu]
    Lxx: jnp.ndarray     # [N, nx, nx]
    Luu: jnp.ndarray     # [N, nu, nu]
    Lxu: jnp.ndarray     # [N, nx, nu]
    x_bar: jnp.ndarray   # [N, nx]
    g_bar: jnp.ndarray   # [N, ng]
    Lx_bar: jnp.ndarray  # [N, nx]
    Lu_bar: jnp.ndarray  # [N, nu]
    imask: jnp.ndarray   # [N, nu] active-input mask (float)
    gmask: jnp.ndarray   # [N, ng] active-inequality mask (float)
    Lx_term: jnp.ndarray     # [nx]
    Lxx_term: jnp.ndarray    # [nx, nx]
    Lx_bar_term: jnp.ndarray  # [nx]


class FmpcSolver:
    """Factory wrapping a problem+config into jitted solve functions."""

    def __init__(self, problem: Problem, config: FmpcConfig = FmpcConfig()):
        assert problem.ineq_const is not None and problem.ineq_dim > 0, (
            "FMPC requires a problem with inequality constraints"
        )
        self.problem = problem
        self.config = config
        self.raw_solve = full_precision(
            functools.partial(_solve, problem, config))
        # natively-batched path with the batch-minor Riccati kernel
        self.raw_solve_batch = full_precision(
            functools.partial(_solve_batched, problem, config))
        self._solve = jax.jit(self.raw_solve)
        self._solve_batch = jax.jit(self.raw_solve_batch)

    def solve(self, t0, x0, variable: FmpcVariable,
              barrier_eps=_BARRIER_EPS_INIT) -> FmpcResult:
        """One solve (``FmpcSolver::solve``, ``FmpcSolver.hpp:158-257``).
        ``variable`` is the warm start (full primal-dual state)."""
        return self._solve(t0, x0, variable, jnp.asarray(barrier_eps))

    def solve_batch(self, t0, x0s, variables, barrier_epss) -> FmpcResult:
        return self._solve_batch(t0, x0s, variables, barrier_epss)


# --------------------------------------------------------------------------


def _masks_at(problem, t, dtype):
    im = problem.input_mask_at(t).astype(dtype)
    gm = problem.ineq_mask_at(t).astype(dtype)
    return im, gm


def _coeffs(problem: Problem, config: FmpcConfig, t0, x0, var: FmpcVariable,
            ) -> _Coeffs:
    """Linearized KKT coefficients (``FmpcSolver.hpp:401-440``)."""
    N = config.horizon_steps
    dt = problem.dt
    dtype = var.xs.dtype
    ts = t0 + dt * jnp.arange(N, dtype=dtype)

    def one(t, x, x_next, u, lam, lam_next, s, nu):
        im, gm = _masks_at(problem, t, dtype)
        A, B = problem.linearize_dynamics(t, x, u)
        C, D = problem.linearize_ineq(t, x, u)
        Lx, Lu, Lxx, Luu, Lxu = problem.quadraticize_running_cost(t, x, u)

        # masked-dimension embedding (see module docstring)
        B = B * im[None, :]
        Lu = Lu * im
        Luu = Luu * (im[:, None] * im[None, :]) + jnp.diag(1.0 - im)
        Lxu = Lxu * im[None, :]
        C = C * gm[:, None]
        D = D * (gm[:, None] * im[None, :])

        g = problem.ineq_const(t, x, u)
        g = jnp.where(gm > 0, g, -1.0)

        x_bar = problem.dynamics(t, x, u) - x_next          # (2.23c)
        g_bar = jnp.where(gm > 0, g + s, 0.0)               # (2.23d)
        Lx_bar = -lam + dt * Lx + A.T @ lam_next + C.T @ nu  # (2.25b)
        Lu_bar = dt * Lu + B.T @ lam_next + D.T @ nu         # (2.25c)
        return (A, B, C, D, Lx, Lu, Lxx, Luu, Lxu,
                x_bar, g_bar, Lx_bar, Lu_bar, im, gm)

    outs = jax.vmap(one)(ts, var.xs[:-1], var.xs[1:], var.us,
                         var.lambdas[:-1], var.lambdas[1:], var.ss, var.nus)

    t_term = t0 + N * dt
    Lx_T, Lxx_T = problem.quadraticize_terminal_cost(t_term, var.xs[-1])
    Lx_bar_T = Lx_T - var.lambdas[-1]                        # (2.25a)

    return _Coeffs(*outs, Lx_T, Lxx_T, Lx_bar_T)


def _kkt_error(x0, var: FmpcVariable, co: _Coeffs, barrier_eps):
    """KKT residual norm (``FmpcSolver.hpp:496-521``); complementarity term
    is max(s∘nu - eps, 0) on active rows."""
    e = jnp.sum((x0 - var.xs[0]) ** 2)
    e += jnp.sum(co.x_bar**2) + jnp.sum(co.g_bar**2)
    e += jnp.sum(co.Lx_bar**2) + jnp.sum(co.Lu_bar**2)
    comp = jnp.maximum(var.ss * var.nus - barrier_eps, 0.0) * co.gmask
    e += jnp.sum(comp**2)
    e += jnp.sum(co.Lx_bar_term**2)
    return jnp.sqrt(e)


def _backward(problem: Problem, config: FmpcConfig, co: _Coeffs,
              var: FmpcVariable, barrier_eps):
    """Condensed Riccati recursion (``FmpcSolver.hpp:524-665``).
    Returns (ks, Ks, ss_vec, Ps, ok_pd, finite)."""
    dt = problem.dt
    dtype = var.xs.dtype
    nu_dim = problem.input_dim

    s_T = -co.Lx_bar_term    # (2.34)
    P_T = co.Lxx_term

    def bstep(carry, inp):
        s_vec, P, ok = carry
        (A, B, C, D, Lxx, Luu, Lxu, x_bar, g_bar, Lx_bar, Lu_bar,
         s_i, nu_i, gm) = inp

        nu_s = jnp.where(gm > 0, nu_i / s_i, 0.0)
        tilde_sub = jnp.where(
            gm > 0, nu_s * g_bar - nu_i + barrier_eps / s_i, 0.0
        )
        Qxx_t = dt * Lxx + C.T @ (nu_s[:, None] * C)         # (2.28c)
        Quu_t = dt * Luu + D.T @ (nu_s[:, None] * D)         # (2.28e)
        Qxu_t = dt * Lxu + C.T @ (nu_s[:, None] * D)         # (2.28d)
        Lx_t = Lx_bar + C.T @ tilde_sub                      # (2.28f)
        Lu_t = Lu_bar + D.T @ tilde_sub                      # (2.28g)

        F = Qxx_t + A.T @ P @ A                              # (2.35b)
        H = Qxu_t + A.T @ P @ B                              # (2.35c)
        G = Quu_t + B.T @ P @ B                              # (2.35d)

        rhs_k = B.T @ (P @ x_bar - s_vec) + Lu_t
        chol_safe, pd = cholesky_small(G)
        k_chol = -cho_solve_small(chol_safe, rhs_k)
        K_chol = -cho_solve_small(chol_safe, H.T)
        if config.break_if_llt_fails:
            k, K = k_chol, K_chol
            ok = ok & pd
        else:
            # LU fallback on non-PD G (FmpcSolver.hpp:608-617)
            k_lu = -lu_solve_small(G, rhs_k)
            K_lu = -lu_solve_small(G, H.T)
            k = jnp.where(pd, k_chol, k_lu)
            K = jnp.where(pd, K_chol, K_lu)

        s_new = A.T @ (s_vec - P @ x_bar) - Lx_t - H @ k     # (2.35a)
        P_new = F - K.T @ G @ K                              # (2.35a)
        P_new = 0.5 * (P_new + P_new.T)

        return (s_new, P_new, ok), (k, K, s_new, P_new)

    inputs = (co.A, co.B, co.C, co.D, co.Lxx, co.Luu, co.Lxu,
              co.x_bar, co.g_bar, co.Lx_bar, co.Lu_bar,
              var.ss, var.nus, co.gmask)
    (_, _, ok), (ks, Ks, ss_vec, Ps) = lax.scan(
        bstep, (s_T, P_T, jnp.bool_(True)), inputs, reverse=True
    )
    # include the terminal (s, P) at index N
    ss_all = jnp.concatenate([ss_vec, s_T[None]], axis=0)
    Ps_all = jnp.concatenate([Ps, P_T[None]], axis=0)

    finite = jnp.bool_(True)
    if config.check_nan:
        finite = (jnp.all(jnp.isfinite(ks)) & jnp.all(jnp.isfinite(Ks))
                  & jnp.all(jnp.isfinite(ss_all)) & jnp.all(jnp.isfinite(Ps_all)))
    return ks, Ks, ss_all, Ps_all, ok, finite


def _backward_bm(problem: Problem, config: FmpcConfig, co, ss, nus, gms,
                 barrier_eps):
    """Batch-minor condensed Riccati for the batched solve path.

    Same math as :func:`_backward` (``FmpcSolver.hpp:524-665``) with the
    batch on the vector lanes (see kernels/ddp_backward.py for why this
    layout keeps the batch on the fast axis).  ``co`` fields (a :class:`_StCoeffs`)
    arrive ALREADY batch-minor [N, small_dims..., B] — zero in-loop layout
    transposes; ``ss``/``nus`` are [N, ng, B], ``gms`` [N, ng] (masks are
    lane-independent), ``barrier_eps`` per-lane [B].
    Returns (ks, Ks, ss_vec, Ps, ok_pd, finite) in batch-minor layout.
    """
    from nmpc_tpu.kernels.ddp_backward import _mm, _mT, _mv
    from nmpc_tpu.kernels.ddp_backward import _chol_bl, _chol_solve_bl
    from nmpc_tpu.solvers.parallel_riccati import _inv_bl

    dt = problem.dt
    B = barrier_eps.shape[0]

    A, Bm, C, D = co.A, co.B, co.C, co.D
    Lxx, Luu, Lxu = co.Lxx, co.Luu, co.Lxu
    x_bar, g_bar = co.x_bar, co.g_bar
    Lx_bar, Lu_bar = co.Lx_bar, co.Lu_bar
    ss_s, nus_s = ss, nus

    s_T = -co.Lx_bar_term                        # [nx, B]
    P_T = co.Lxx_term                            # [nx, nx, B]

    def bstep(carry, inp):
        s_vec, P, ok = carry
        (A_, B_, C_, D_, Lxx_, Luu_, Lxu_, xb, gb, Lxb, Lub,
         s_i, nu_i, gm_row) = inp

        gm_i = gm_row[:, None]                               # [ng, 1]
        nu_s = jnp.where(gm_i > 0, nu_i / s_i, 0.0)          # [ng, B]
        tilde = jnp.where(gm_i > 0,
                          nu_s * gb - nu_i + barrier_eps[None, :] / s_i, 0.0)
        CT = _mT(C_)                                         # [nx, ng, B]
        DT = _mT(D_)                                         # [nu, ng, B]
        Qxx_t = dt * Lxx_ + _mm(CT, nu_s[:, None, :] * C_)
        Quu_t = dt * Luu_ + _mm(DT, nu_s[:, None, :] * D_)
        Qxu_t = dt * Lxu_ + _mm(CT, nu_s[:, None, :] * D_)
        Lx_t = Lxb + _mv(CT, tilde)
        Lu_t = Lub + _mv(DT, tilde)

        AT = _mT(A_)
        BT = _mT(B_)
        PA = _mm(P, A_)
        PB = _mm(P, B_)
        F = Qxx_t + _mm(AT, PA)
        H = Qxu_t + _mm(AT, PB)
        G = Quu_t + _mm(BT, PB)

        rhs_k = _mv(BT, _mv(P, xb) - s_vec) + Lu_t           # [nu, B]
        L, pd = _chol_bl(G)
        k_chol = -_chol_solve_bl(L, rhs_k[:, None, :])[:, 0, :]
        K_chol = -_chol_solve_bl(L, _mT(H))
        if config.break_if_llt_fails:
            k, K = k_chol, K_chol
            ok = ok & pd
        else:
            Ginv = _inv_bl(G)
            k_lu = -_mv(Ginv, rhs_k)
            K_lu = -_mm(Ginv, _mT(H))
            k = jnp.where(pd[None, :], k_chol, k_lu)
            K = jnp.where(pd[None, None, :], K_chol, K_lu)

        s_new = _mv(AT, s_vec - _mv(P, xb)) - Lx_t - _mv(H, k)
        P_new = F - _mm(_mT(K), _mm(G, K))
        P_new = 0.5 * (P_new + _mT(P_new))
        return (s_new, P_new, ok), (k, K, s_new, P_new)

    inputs = (A, Bm, C, D, Lxx, Luu, Lxu, x_bar, g_bar, Lx_bar, Lu_bar,
              ss_s, nus_s, gms)
    B_ones = jnp.ones((B,), dtype=bool)
    (_, _, ok), (ks, Ks, svecs, Ps) = lax.scan(
        bstep, (s_T, P_T, B_ones), inputs, reverse=True)

    ss_all = jnp.concatenate([svecs, s_T[None]], axis=0)     # [N+1, nx, B]
    Ps_all = jnp.concatenate([Ps, P_T[None]], axis=0)

    finite = jnp.ones((B,), dtype=bool)
    if config.check_nan:
        def fin(a):
            return jnp.all(jnp.isfinite(a), axis=tuple(range(a.ndim - 1)))
        finite = fin(ks) & fin(Ks) & fin(ss_all) & fin(Ps_all)

    return (ks, Ks, ss_all, Ps_all, ok, finite)


def _forward(problem, config, co: _Coeffs, var: FmpcVariable, x0,
             ks, Ks, ss_vec, Ps, barrier_eps):
    """Forward recursion for the Newton direction (``FmpcSolver.hpp:668-708``).
    Returns delta variable + finite flag."""
    dx0 = x0 - var.xs[0]

    def fstep(dx, inp):
        A, B, x_bar, k, K = inp
        du = K @ dx + k                                      # (2.36)
        dx_next = A @ dx + B @ du + x_bar                    # (2.26b)
        return dx_next, (dx, du)

    _, (dxs, dus) = lax.scan(fstep, dx0, (co.A, co.B, co.x_bar, ks, Ks))
    dxs = jnp.concatenate([dxs, (co.A[-1] @ dxs[-1] + co.B[-1] @ dus[-1]
                                 + co.x_bar[-1])[None]], axis=0)
    # Δλ_i = P_i Δx_i - s_i  (2.33)
    dlams = jnp.einsum("nij,nj->ni", Ps, dxs) - ss_vec

    # Δs, Δν (2.27a-b); masked rows pinned to zero
    dss = -(jnp.einsum("nij,nj->ni", co.C, dxs[:-1])
            + jnp.einsum("nij,nj->ni", co.D, dus) + co.g_bar)
    dnus = -(var.nus * (dss + var.ss) - barrier_eps) / var.ss
    dss = dss * co.gmask
    dnus = dnus * co.gmask

    delta = FmpcVariable(xs=dxs, us=dus, lambdas=dlams, ss=dss, nus=dnus)
    finite = jnp.bool_(True)
    if config.check_nan:
        finite = jax.tree_util.tree_reduce(
            lambda a, leaf: a & jnp.all(jnp.isfinite(leaf)),
            delta, jnp.bool_(True),
        )
    return delta, finite


def _l1_dir_deriv(func, jac_dot_dir):
    """Directional derivative of ||func||_1 along jac@dir
    (Nocedal & Wright A.51; reference ``MathUtils.h:17-38``)."""
    return jnp.sum(jnp.where(func > 0, jac_dot_dir,
                             jnp.where(func < 0, -jac_dot_dir,
                                       jnp.abs(jac_dot_dir))))


def _merit_pieces(problem, config, t0, x0, var: FmpcVariable, barrier_eps,
                  gmask):
    """(merit_obj, merit_const) of the l1 merit function
    (``FmpcSolver.hpp:936-982``)."""
    N = config.horizon_steps
    dt = problem.dt
    dtype = var.xs.dtype
    ts = t0 + dt * jnp.arange(N, dtype=dtype)

    def stage(t, x, x_next, u, s, gm):
        obj = problem.running_cost(t, x, u) * dt
        obj += -barrier_eps * jnp.sum(jnp.where(gm > 0, jnp.log(s), 0.0))
        cx = problem.dynamics(t, x, u) - x_next
        g = jnp.where(gm > 0, problem.ineq_const(t, x, u) + s, 0.0)
        const = jnp.sum(jnp.abs(cx)) + jnp.sum(jnp.abs(g))
        return obj, const

    gms = jax.vmap(lambda t: problem.ineq_mask_at(t).astype(dtype))(ts)
    objs, consts = jax.vmap(stage)(ts, var.xs[:-1], var.xs[1:], var.us,
                                   var.ss, gms)
    obj = jnp.sum(objs) + problem.terminal_cost(t0 + N * dt, var.xs[-1])
    const = jnp.sum(consts) + jnp.sum(jnp.abs(x0 - var.xs[0]))
    return obj, const


def _update(problem, config, t0, x0, co: _Coeffs, var: FmpcVariable,
            delta: FmpcVariable, barrier_eps):
    """Fraction-to-boundary + optional line search + variable update
    (``FmpcSolver.hpp:711-834``). Returns (new_var, ok)."""
    gm = co.gmask

    def ftb(v, dv):
        cand = jnp.where((dv < 0) & (gm > 0), -_FTB_MARGIN * v / dv, 1.0)
        return jnp.minimum(1.0, jnp.min(cand))

    alpha_s_max = ftb(var.ss, delta.ss)
    alpha_nu_max = ftb(var.nus, delta.nus)
    valid = ((alpha_s_max > 0.0) & (alpha_s_max <= 1.0)
             & (alpha_nu_max > 0.0) & (alpha_nu_max <= 1.0))

    alpha_s = alpha_s_max
    alpha_nu = alpha_nu_max

    if config.enable_line_search:
        # setupMeritFunc (FmpcSolver.hpp:837-933)
        dt = problem.dt
        merit_obj, merit_const = _merit_pieces(
            problem, config, t0, x0, var, barrier_eps, gm)
        # objective directional derivative
        d_obj = jnp.sum((co.Lx * delta.xs[:-1]).sum(-1) * dt
                        + (co.Lu * delta.us).sum(-1) * dt)
        d_obj += -barrier_eps * jnp.sum(
            jnp.where(gm > 0, delta.ss / var.ss, 0.0))
        d_obj += co.Lx_term @ delta.xs[-1]
        # constraint directional derivative via l1 rules
        cx0 = x0 - var.xs[0]
        d_const = _l1_dir_deriv(cx0, -delta.xs[0])
        Adx = jnp.einsum("nij,nj->ni", co.A, delta.xs[:-1])
        Bdu = jnp.einsum("nij,nj->ni", co.B, delta.us)
        Cdx = jnp.einsum("nij,nj->ni", co.C, delta.xs[:-1])
        Ddu = jnp.einsum("nij,nj->ni", co.D, delta.us)
        # per-stage residuals recomputed like the reference (not from coeffs)
        d_const += jnp.sum(jax.vmap(_l1_dir_deriv)(co.x_bar, Adx))
        d_const += jnp.sum(jax.vmap(_l1_dir_deriv)(co.x_bar, Bdu))
        d_const += jnp.sum(jax.vmap(_l1_dir_deriv)(co.x_bar, -delta.xs[1:]))
        d_const += jnp.sum(jax.vmap(_l1_dir_deriv)(co.g_bar, Cdx))
        d_const += jnp.sum(jax.vmap(_l1_dir_deriv)(co.g_bar, Ddu))
        d_const += jnp.sum(jax.vmap(_l1_dir_deriv)(co.g_bar, delta.ss))

        if config.merit_const_scale_from_lagrange_multipliers:
            scale = jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(var.lambdas)),
                            jnp.max(jnp.abs(var.nus * gm))), 1e-3)
        else:
            rho = 0.5
            scale = jnp.maximum(d_obj / ((1.0 - rho) * merit_const), 1e-3)

        merit0 = merit_obj + scale * merit_const
        merit_deriv = d_obj + scale * d_const

        armijo_scale = 1e-3
        alpha_min = 1e-10

        def merit_at(alpha):
            v = FmpcVariable(
                xs=var.xs + alpha * delta.xs,
                us=var.us + alpha * delta.us,
                lambdas=var.lambdas,
                ss=var.ss + alpha * delta.ss,
                nus=var.nus,
            )
            o, c = _merit_pieces(problem, config, t0, x0, v, barrier_eps, gm)
            return o + scale * c

        def ls_cond(carry):
            alpha, it = carry
            fail = merit_at(alpha) >= merit0 + armijo_scale * alpha * merit_deriv
            return fail & (alpha >= alpha_min) & (it < config.max_line_search_iter)

        def ls_body(carry):
            alpha, it = carry
            return (alpha * 0.5, it + 1)

        alpha_s, _ = lax.while_loop(ls_cond, ls_body, (alpha_s, jnp.int32(0)))

    new_var = FmpcVariable(
        xs=var.xs + alpha_s * delta.xs,
        us=var.us + alpha_s * delta.us,
        lambdas=var.lambdas + alpha_nu * delta.lambdas,
        ss=var.ss + alpha_s * delta.ss,
        nus=var.nus + alpha_nu * delta.nus,
    )
    return new_var, valid


class _State(NamedTuple):
    steps: jnp.ndarray    # full Newton steps taken (loop bound)
    iters: jnp.ndarray    # procOnce count = KKT checks performed
    status: jnp.ndarray
    var: FmpcVariable
    co: _Coeffs           # coefficients of `var` (carried check-first)
    kkt: jnp.ndarray
    ks: jnp.ndarray
    Ks: jnp.ndarray
    eps: jnp.ndarray
    trace_kkt: jnp.ndarray


def _solve(problem: Problem, config: FmpcConfig, t0, x0,
           variable: FmpcVariable, barrier_eps0) -> FmpcResult:
    """Full FMPC solve (``FmpcSolver::solve``, ``FmpcSolver.hpp:158-257``).

    Check-first loop structure: the reference returns from procOnce BEFORE
    the backward pass when the KKT error is already below threshold
    (``FmpcSolver.hpp:443-448``).  Under ``lax.while_loop`` that maps to:
    run the (barrier update, coefficients, KKT check) phase once before the
    loop and again at the END of each body for the next iterate, carrying
    (co, kkt, eps) in the state — so a converged iterate never pays for a
    backward/forward/update it would discard, and no ``lax.cond`` barrier
    sits in the hot body.  Iteration-for-iteration equivalent to the
    reference's procOnce sequence (same counts, traces, statuses).
    """
    dtype = x0.dtype
    t0 = jnp.asarray(t0, dtype)
    N = config.horizon_steps
    nx, nu_dim, ng = problem.state_dim, problem.input_dim, problem.ineq_dim
    dt = problem.dt
    ts = t0 + dt * jnp.arange(N, dtype=dtype)
    gms = jax.vmap(lambda t: problem.ineq_mask_at(t).astype(dtype))(ts)

    var = variable
    eps = jnp.asarray(barrier_eps0, dtype)

    if config.init_complementary_variable:
        # (FmpcSolver.hpp:171-188)
        margin, cmin = 1e-2, 1e-2
        eps = jnp.asarray(_BARRIER_EPS_INIT, dtype)
        g0 = jax.vmap(problem.ineq_const)(ts, var.xs[:-1], var.us)
        ss = (1.0 + margin) * jnp.maximum(-g0, cmin)
        nus = (1.0 + margin) * jnp.maximum(eps / ss, cmin)
        var = FmpcVariable(var.xs, var.us, var.lambdas, ss, nus)

    # pin masked inequality rows to the inert fixed point (s=1, nu=0)
    var = FmpcVariable(
        xs=var.xs, us=var.us, lambdas=var.lambdas,
        ss=jnp.where(gms > 0, var.ss, 1.0),
        nus=jnp.where(gms > 0, var.nus, 0.0),
    )

    n_active = jnp.maximum(jnp.sum(gms), 1.0)

    # The reference rejects negative (s, nu) warm starts with an exception
    # (checkVariable, FmpcSolver.hpp:348-362); batched equivalent: per-lane
    # UNINITIALIZED status, lane untouched.
    ws_valid = jnp.all(var.ss * gms >= 0) & jnp.all(var.nus * gms >= 0)

    def check(var, eps):
        """Barrier update + coefficients + KKT error: the procOnce prefix
        (FmpcSolver.hpp:377-448)."""
        if config.update_barrier_eps:
            s_nu_ave = jnp.sum(var.ss * var.nus * gms) / n_active
            eps = jnp.clip(_SIGMA * s_nu_ave, _BARRIER_EPS_MIN,
                           _BARRIER_EPS_MAX)
        co = _coeffs(problem, config, t0, x0, var)
        kkt = _kkt_error(x0, var, co, jnp.zeros((), dtype))
        return co, kkt, eps

    # first check (procOnce #1 prefix) happens before the loop
    co1, kkt1, eps1 = check(var, eps)
    succeeded1 = kkt1 <= config.kkt_error_thre
    status0 = jnp.where(succeeded1, jnp.int32(FmpcStatus.SUCCEEDED),
                        jnp.int32(FmpcStatus.ITERATION_CONTINUED))
    status0 = jnp.where(ws_valid, status0,
                        jnp.int32(FmpcStatus.UNINITIALIZED))
    trace0 = jnp.zeros((config.max_iter + 1,), dtype)
    trace0 = jnp.where(ws_valid, trace0.at[1].set(kkt1), trace0)

    state = _State(
        steps=jnp.int32(0),
        iters=jnp.where(ws_valid, jnp.int32(1), jnp.int32(0)),
        status=status0,
        var=var,
        co=co1,
        kkt=jnp.where(ws_valid, kkt1, jnp.asarray(jnp.inf, dtype)),
        ks=jnp.zeros((N, nu_dim), dtype),
        Ks=jnp.zeros((N, nu_dim, nx), dtype),
        eps=jnp.where(ws_valid, eps1, eps),
        trace_kkt=trace0,
    )

    def cond(s: _State):
        return (s.status == FmpcStatus.ITERATION_CONTINUED) & (
            s.steps < config.max_iter)

    def body(s: _State):
        steps = s.steps + 1
        var = s.var
        eps = s.eps
        co = s.co

        ks, Ks, ss_vec, Ps, bw_ok, bw_finite = _backward(
            problem, config, co, var, eps)
        bw_good = bw_ok & bw_finite
        delta, fw_finite = _forward(problem, config, co, var, x0,
                                    ks, Ks, ss_vec, Ps, eps)
        new_var, up_ok = _update(problem, config, t0, x0, co, var,
                                 delta, eps)

        status = jnp.int32(FmpcStatus.ITERATION_CONTINUED)
        status = jnp.where(~up_ok, jnp.int32(FmpcStatus.ERROR_IN_UPDATE), status)
        status = jnp.where(~fw_finite, jnp.int32(FmpcStatus.ERROR_IN_FORWARD), status)
        status = jnp.where(~bw_good, jnp.int32(FmpcStatus.ERROR_IN_BACKWARD), status)

        advance = status == FmpcStatus.ITERATION_CONTINUED
        var_out = jax.tree_util.tree_map(
            lambda new, old: jnp.where(advance, new, old), new_var, var)
        # gains always reflect the last backward pass that ran (the
        # reference stores them into coeff_list_ during backwardPass)
        ks_out = jnp.where(bw_good, ks, s.ks)
        Ks_out = jnp.where(bw_good, Ks, s.Ks)

        # next check (procOnce #steps+1 prefix), gated by the iteration cap
        co2, kkt2, eps2 = check(var_out, eps)
        do_check = advance & (s.iters < config.max_iter)
        iters = jnp.where(do_check, s.iters + 1, s.iters)
        succeeded = do_check & (kkt2 <= config.kkt_error_thre)
        status = jnp.where(succeeded, jnp.int32(FmpcStatus.SUCCEEDED), status)
        kkt = jnp.where(do_check, kkt2, s.kkt)
        eps = jnp.where(do_check, eps2, eps)
        co_out = jax.tree_util.tree_map(
            lambda new, old: jnp.where(do_check, new, old), co2, co)
        trace_kkt = jnp.where(do_check, s.trace_kkt.at[iters].set(kkt2),
                              s.trace_kkt)

        # print_level diagnostics (reference FmpcSolver.h:60-61 gate)
        from nmpc_tpu.utils.logging import log, log_when

        log(config.print_level, 3,
            "[FMPC] iter {it}: kkt_error {kkt:.6e} barrier_eps {eps:.3e}",
            it=iters, kkt=kkt, eps=eps)
        log_when(config.print_level, 1, ~bw_good,
                 "[FMPC/Warning] Error in backward pass (iter {it})", it=iters)
        log_when(config.print_level, 1, ~fw_finite,
                 "[FMPC/Warning] Error in forward pass (iter {it})", it=iters)
        log_when(config.print_level, 1, ~up_ok,
                 "[FMPC/Warning] Error in update (iter {it})", it=iters)

        return _State(steps=steps, iters=iters, status=status, var=var_out,
                      co=co_out, kkt=kkt, ks=ks_out, Ks=Ks_out, eps=eps,
                      trace_kkt=trace_kkt)

    out = lax.while_loop(cond, body, state)
    status = jnp.where(
        out.status == FmpcStatus.ITERATION_CONTINUED,
        jnp.int32(FmpcStatus.MAX_ITERATION_REACHED), out.status)

    return FmpcResult(
        status=status,
        iters=out.iters,
        variable=out.var,
        kkt_error=out.kkt,
        ks=out.ks,
        Ks=out.Ks,
        barrier_eps=out.eps,
        trace=FmpcTrace(
            iter=jnp.arange(config.max_iter + 1, dtype=jnp.int32),
            kkt_error=out.trace_kkt,
        ),
    )


# --------------------------------------------------------------------------
# natively-batched solve — batch-minor END TO END (coeffs, KKT, backward,
# forward, update) with zero in-loop layout transposes, mirroring the DDP
# stacked path (solvers/ddp.py::_solve_stacked / kernels/ddp_backward.py).
# --------------------------------------------------------------------------


class _StCoeffs(NamedTuple):
    """Linearized-KKT coefficients, batch-minor: stage axis leading, batch
    axis TRAILING on every leaf (``[N, small_dims..., B]``)."""

    A: jnp.ndarray        # [N, nx, nx, B]
    B: jnp.ndarray        # [N, nx, nu, B]
    C: jnp.ndarray        # [N, ng, nx, B]
    D: jnp.ndarray        # [N, ng, nu, B]
    Lx: jnp.ndarray       # [N, nx, B]
    Lu: jnp.ndarray       # [N, nu, B]
    Lxx: jnp.ndarray      # [N, nx, nx, B]
    Luu: jnp.ndarray      # [N, nu, nu, B]
    Lxu: jnp.ndarray      # [N, nx, nu, B]
    x_bar: jnp.ndarray    # [N, nx, B]
    g_bar: jnp.ndarray    # [N, ng, B]
    Lx_bar: jnp.ndarray   # [N, nx, B]
    Lu_bar: jnp.ndarray   # [N, nu, B]
    Lx_term: jnp.ndarray      # [nx, B]
    Lxx_term: jnp.ndarray     # [nx, nx, B]
    Lx_bar_term: jnp.ndarray  # [nx, B]


def _coeffs_bm(problem: Problem, config: FmpcConfig, t0, var: FmpcVariable,
               ) -> _StCoeffs:
    """Batch-minor coefficient sweep (``FmpcSolver.hpp:401-440``).

    ``var`` leaves are batch-minor ``[N(+1), dim, B]``; the per-instance
    stage function is double-vmapped (batch on ``out_axes=-1``, then the
    stage axis) so coefficients are produced natively batch-minor — no
    layout transpose between the sweep and the Riccati kernel.
    """
    N = config.horizon_steps
    dt = problem.dt
    dtype = var.xs.dtype
    ts = t0 + dt * jnp.arange(N, dtype=dtype)

    def one(t, x, x_next, u, lam, lam_next, s, nu):
        im, gm = _masks_at(problem, t, dtype)
        A, B = problem.linearize_dynamics(t, x, u)
        C, D = problem.linearize_ineq(t, x, u)
        Lx, Lu, Lxx, Luu, Lxu = problem.quadraticize_running_cost(t, x, u)

        B = B * im[None, :]
        Lu = Lu * im
        Luu = Luu * (im[:, None] * im[None, :]) + jnp.diag(1.0 - im)
        Lxu = Lxu * im[None, :]
        C = C * gm[:, None]
        D = D * (gm[:, None] * im[None, :])

        g = problem.ineq_const(t, x, u)
        g = jnp.where(gm > 0, g, -1.0)

        x_bar = problem.dynamics(t, x, u) - x_next
        g_bar = jnp.where(gm > 0, g + s, 0.0)
        Lx_bar = -lam + dt * Lx + A.T @ lam_next + C.T @ nu
        Lu_bar = dt * Lu + B.T @ lam_next + D.T @ nu
        return (A, B, C, D, Lx, Lu, Lxx, Luu, Lxu,
                x_bar, g_bar, Lx_bar, Lu_bar)

    ax = (None,) + (-1,) * 7
    one_b = jax.vmap(one, in_axes=ax, out_axes=-1)
    outs = jax.vmap(one_b)(ts, var.xs[:-1], var.xs[1:], var.us,
                           var.lambdas[:-1], var.lambdas[1:], var.ss, var.nus)

    t_term = t0 + N * dt
    term_b = jax.vmap(problem.quadraticize_terminal_cost,
                      in_axes=(None, -1), out_axes=-1)
    Lx_T, Lxx_T = term_b(t_term, var.xs[-1])
    Lx_bar_T = Lx_T - var.lambdas[-1]

    return _StCoeffs(*outs, Lx_T, Lxx_T, Lx_bar_T)


def _kkt_error_bm(x0_b, var: FmpcVariable, co: _StCoeffs, barrier_eps, gms):
    """Per-lane KKT residual norm (``FmpcSolver.hpp:496-521``); all args
    batch-minor, ``barrier_eps`` [B], ``gms`` [N, ng].  Returns [B]."""
    e = jnp.sum((x0_b - var.xs[0]) ** 2, axis=0)
    e += jnp.sum(co.x_bar**2, axis=(0, 1)) + jnp.sum(co.g_bar**2, axis=(0, 1))
    e += jnp.sum(co.Lx_bar**2, axis=(0, 1)) + jnp.sum(co.Lu_bar**2, axis=(0, 1))
    comp = jnp.maximum(var.ss * var.nus - barrier_eps[None, None, :], 0.0)
    comp = comp * gms[:, :, None]
    e += jnp.sum(comp**2, axis=(0, 1))
    e += jnp.sum(co.Lx_bar_term**2, axis=0)
    return jnp.sqrt(e)


def _forward_bm(problem, config, co: _StCoeffs, var: FmpcVariable, x0_b,
                ks, Ks, ss_vec, Ps, barrier_eps, gms, fused: bool = False):
    """Batch-minor forward recursion (``FmpcSolver.hpp:668-708``).
    Returns (delta variable [batch-minor leaves], finite [B]).

    ``fused=True`` runs the (dxs, dus) stage recursion — the only
    sequential part — in one Pallas program per B-subblock
    (``kernels/fmpc_forward_pallas.py``); the Δλ/Δs/Δν post-passes are
    elementwise over the big Ps/C/D buffers and stay here (XLA fuses
    them into single passes either way)."""
    from nmpc_tpu.kernels.ddp_backward import _mm, _mv

    dx0 = x0_b - var.xs[0]                                   # [nx, B]

    if fused:
        from nmpc_tpu.kernels.fmpc_forward_pallas import (
            forward_fmpc_deltas_pallas)

        dxs, dus = forward_fmpc_deltas_pallas(co.A, co.B, co.x_bar, ks,
                                              Ks, dx0)
    else:
        def fstep(dx, inp):
            A, Bm, x_bar, k, K = inp
            du = _mv(K, dx) + k                              # (2.36)
            dx_next = _mv(A, dx) + _mv(Bm, du) + x_bar       # (2.26b)
            return dx_next, (dx, du)

        _, (dxs, dus) = lax.scan(fstep, dx0, (co.A, co.B, co.x_bar, ks, Ks))
        dx_T = _mv(co.A[-1], dxs[-1]) + _mv(co.B[-1], dus[-1]) + co.x_bar[-1]
        dxs = jnp.concatenate([dxs, dx_T[None]], axis=0)     # [N+1, nx, B]
    # Δλ_i = P_i Δx_i - s_i  (2.33); Ps [N+1, nx, nx, B]
    dlams = jnp.sum(Ps * dxs[:, None, :, :], axis=2) - ss_vec

    # Δs, Δν (2.27a-b); masked rows pinned to zero
    Cdx = jnp.sum(co.C * dxs[:-1][:, None, :, :], axis=2)    # [N, ng, B]
    Ddu = jnp.sum(co.D * dus[:, None, :, :], axis=2)
    dss = -(Cdx + Ddu + co.g_bar)
    dnus = -(var.nus * (dss + var.ss) - barrier_eps[None, None, :]) / var.ss
    gm3 = gms[:, :, None]
    dss = dss * gm3
    dnus = dnus * gm3

    delta = FmpcVariable(xs=dxs, us=dus, lambdas=dlams, ss=dss, nus=dnus)
    B = x0_b.shape[-1]
    finite = jnp.ones((B,), dtype=bool)
    if config.check_nan:
        def fin(a):
            return jnp.all(jnp.isfinite(a), axis=tuple(range(a.ndim - 1)))
        finite = jax.tree_util.tree_reduce(
            lambda acc, leaf: acc & fin(leaf), delta, finite)
    return delta, finite


def _merit_pieces_bm(problem, config, t0, x0_b, var: FmpcVariable,
                     barrier_eps, gms):
    """Per-lane (merit_obj, merit_const) of the l1 merit function
    (``FmpcSolver.hpp:936-982``); batch-minor leaves, returns ([B], [B])."""
    N = config.horizon_steps
    dt = problem.dt
    dtype = var.xs.dtype
    ts = t0 + dt * jnp.arange(N, dtype=dtype)

    def stage(eps, t, x, x_next, u, s):
        gm = problem.ineq_mask_at(t).astype(dtype)
        obj = problem.running_cost(t, x, u) * dt
        obj += -eps * jnp.sum(jnp.where(gm > 0, jnp.log(s), 0.0))
        cx = problem.dynamics(t, x, u) - x_next
        g = jnp.where(gm > 0, problem.ineq_const(t, x, u) + s, 0.0)
        const = jnp.sum(jnp.abs(cx)) + jnp.sum(jnp.abs(g))
        return obj, const

    stage_b = jax.vmap(stage, in_axes=(-1, None, -1, -1, -1, -1),
                       out_axes=-1)
    objs, consts = jax.vmap(stage_b, in_axes=(None, 0, 0, 0, 0, 0))(
        barrier_eps, ts, var.xs[:-1], var.xs[1:], var.us, var.ss)

    term_b = jax.vmap(problem.terminal_cost, in_axes=(None, -1), out_axes=-1)
    obj = jnp.sum(objs, axis=0) + term_b(t0 + N * dt, var.xs[-1])
    const = (jnp.sum(consts, axis=0)
             + jnp.sum(jnp.abs(x0_b - var.xs[0]), axis=0))
    return obj, const


def _l1_dir_deriv_bm(func, jac_dot_dir):
    """Per-lane directional derivative of ||func||_1 along jac@dir; inputs
    [N, dim, B] (or [dim, B]), reduced over all but the batch axis."""
    d = jnp.where(func > 0, jac_dot_dir,
                  jnp.where(func < 0, -jac_dot_dir, jnp.abs(jac_dot_dir)))
    return jnp.sum(d, axis=tuple(range(d.ndim - 1)))


def _update_bm(problem, config, t0, x0_b, co: _StCoeffs, var: FmpcVariable,
               delta: FmpcVariable, barrier_eps, gms):
    """Batch-minor fraction-to-boundary + optional line search + update
    (``FmpcSolver.hpp:711-834``).  Per-lane control flow reproduces
    ``_update``-under-vmap exactly.  Returns (new_var, valid [B])."""
    gm3 = gms[:, :, None]

    def ftb(v, dv):
        cand = jnp.where((dv < 0) & (gm3 > 0), -_FTB_MARGIN * v / dv, 1.0)
        return jnp.minimum(1.0, jnp.min(cand, axis=(0, 1)))

    alpha_s_max = ftb(var.ss, delta.ss)                      # [B]
    alpha_nu_max = ftb(var.nus, delta.nus)
    valid = ((alpha_s_max > 0.0) & (alpha_s_max <= 1.0)
             & (alpha_nu_max > 0.0) & (alpha_nu_max <= 1.0))

    alpha_s = alpha_s_max
    alpha_nu = alpha_nu_max

    if config.enable_line_search:
        dt = problem.dt
        merit_obj, merit_const = _merit_pieces_bm(
            problem, config, t0, x0_b, var, barrier_eps, gms)
        d_obj = jnp.sum(co.Lx * delta.xs[:-1], axis=(0, 1)) * dt
        d_obj += jnp.sum(co.Lu * delta.us, axis=(0, 1)) * dt
        d_obj += -barrier_eps * jnp.sum(
            jnp.where(gm3 > 0, delta.ss / var.ss, 0.0), axis=(0, 1))
        d_obj += jnp.sum(co.Lx_term * delta.xs[-1], axis=0)

        cx0 = x0_b - var.xs[0]
        d_const = _l1_dir_deriv_bm(cx0, -delta.xs[0])
        Adx = jnp.sum(co.A * delta.xs[:-1][:, None, :, :], axis=2)
        Bdu = jnp.sum(co.B * delta.us[:, None, :, :], axis=2)
        Cdx = jnp.sum(co.C * delta.xs[:-1][:, None, :, :], axis=2)
        Ddu = jnp.sum(co.D * delta.us[:, None, :, :], axis=2)
        d_const += _l1_dir_deriv_bm(co.x_bar, Adx)
        d_const += _l1_dir_deriv_bm(co.x_bar, Bdu)
        d_const += _l1_dir_deriv_bm(co.x_bar, -delta.xs[1:])
        d_const += _l1_dir_deriv_bm(co.g_bar, Cdx)
        d_const += _l1_dir_deriv_bm(co.g_bar, Ddu)
        d_const += _l1_dir_deriv_bm(co.g_bar, delta.ss)

        if config.merit_const_scale_from_lagrange_multipliers:
            scale = jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(var.lambdas), axis=(0, 1)),
                            jnp.max(jnp.abs(var.nus * gm3), axis=(0, 1))),
                1e-3)
        else:
            rho = 0.5
            scale = jnp.maximum(d_obj / ((1.0 - rho) * merit_const), 1e-3)

        merit0 = merit_obj + scale * merit_const
        merit_deriv = d_obj + scale * d_const

        armijo_scale = 1e-3
        alpha_min = 1e-10

        def merit_at(alpha):                                 # alpha [B]
            v = FmpcVariable(
                xs=var.xs + alpha * delta.xs,
                us=var.us + alpha * delta.us,
                lambdas=var.lambdas,
                ss=var.ss + alpha * delta.ss,
                nus=var.nus,
            )
            o, c = _merit_pieces_bm(problem, config, t0, x0_b, v,
                                    barrier_eps, gms)
            return o + scale * c

        def ls_active(alpha, it):
            fail = merit_at(alpha) >= merit0 + armijo_scale * alpha * merit_deriv
            return fail & (alpha >= alpha_min) & (it < config.max_line_search_iter)

        def ls_cond(carry):
            alpha, it = carry
            return jnp.any(ls_active(alpha, it))

        def ls_body(carry):
            alpha, it = carry
            act = ls_active(alpha, it)
            return (jnp.where(act, alpha * 0.5, alpha),
                    jnp.where(act, it + 1, it))

        B = x0_b.shape[-1]
        alpha_s, _ = lax.while_loop(ls_cond, ls_body,
                                    (alpha_s, jnp.zeros((B,), jnp.int32)))

    new_var = FmpcVariable(
        xs=var.xs + alpha_s * delta.xs,
        us=var.us + alpha_s * delta.us,
        lambdas=var.lambdas + alpha_nu * delta.lambdas,
        ss=var.ss + alpha_s * delta.ss,
        nus=var.nus + alpha_nu * delta.nus,
    )
    return new_var, valid


def _bwhere_bm(mask, new, old):
    """Freeze on the TRAILING batch axis: mask [B], leaves [..., B]."""
    return jnp.where(mask, new, old)


class _BState(NamedTuple):
    steps: jnp.ndarray    # scalar: loop bound (full Newton steps)
    iters: jnp.ndarray    # [B] per-lane procOnce count (KKT checks)
    status: jnp.ndarray   # [B]
    var: FmpcVariable     # leaves batch-minor [N(+1), dim, B]
    co: _StCoeffs         # coefficients of `var` (carried check-first)
    kkt: jnp.ndarray      # [B]
    ks: jnp.ndarray       # [N, nu, B]
    Ks: jnp.ndarray       # [N, nu, nx, B]
    eps: jnp.ndarray      # [B]
    trace_kkt: jnp.ndarray  # [B, max_iter+1]


def _resolve_impls(config: FmpcConfig, dtype, ng: int):
    """(backward impl, fused forward?) for the batched solve — the one
    place holding the ``auto`` rules (``FmpcConfig.backward_impl`` /
    ``forward_impl``): the fused Pallas kernels on a GPU for fp32 solves
    (the backward also needs an inequality row), the batch-minor XLA scans
    otherwise."""
    from nmpc_tpu.kernels.lane_kernel import on_gpu

    kernel_ok = on_gpu() and jnp.dtype(dtype) == jnp.float32
    impl = config.backward_impl
    if impl == "auto":
        impl = "pallas" if (kernel_ok and ng >= 1) else "stacked"
    if config.forward_impl == "auto":
        fwd_fused = kernel_ok
    else:
        fwd_fused = config.forward_impl == "fused"
    return impl, fwd_fused


def _solve_batched(problem: Problem, config: FmpcConfig, t0, x0s,
                   variables: FmpcVariable, barrier_eps0s) -> FmpcResult:
    """Natively-batched FMPC solve.  Public layout is batch-first; internally
    EVERYTHING is batch-minor end-to-end — coefficient sweep, KKT error,
    condensed Riccati, forward recursion, fraction-to-boundary and line
    search — so no layout transpose occurs anywhere inside the PDIP loop.
    Check-first loop structure like :func:`_solve`: the (barrier, coeffs,
    KKT) phase runs pre-loop and at the end of each body, so the batch
    never pays a backward/forward/update after its last lane converges
    (the reference's pre-backward return, ``FmpcSolver.hpp:443-448``).
    Per-lane control flow reproduces ``_solve``-under-vmap exactly (tested).
    """
    dtype = x0s.dtype
    t0 = jnp.asarray(t0, dtype)
    B = x0s.shape[0]
    N = config.horizon_steps
    nx, nu_dim, ng = problem.state_dim, problem.input_dim, problem.ineq_dim
    dt = problem.dt
    ts = t0 + dt * jnp.arange(N, dtype=dtype)
    gms = jax.vmap(lambda t: problem.ineq_mask_at(t).astype(dtype))(ts)
    gm3 = gms[:, :, None]

    # one-time layout change at the boundary: batch-first -> batch-minor
    bm = lambda a: jnp.moveaxis(a, 0, -1)
    x0_b = bm(x0s)                                           # [nx, B]
    var = jax.tree_util.tree_map(bm, variables)
    eps = jnp.asarray(barrier_eps0s, dtype)

    if config.init_complementary_variable:
        # (FmpcSolver.hpp:171-188)
        margin, cmin = 1e-2, 1e-2
        eps = jnp.full((B,), _BARRIER_EPS_INIT, dtype)
        ineq_b = jax.vmap(problem.ineq_const, in_axes=(None, -1, -1),
                          out_axes=-1)
        g0 = jax.vmap(ineq_b)(ts, var.xs[:-1], var.us)       # [N, ng, B]
        ss = (1.0 + margin) * jnp.maximum(-g0, cmin)
        nus = (1.0 + margin) * jnp.maximum(eps[None, None, :] / ss, cmin)
        var = FmpcVariable(var.xs, var.us, var.lambdas, ss, nus)

    # pin masked inequality rows to the inert fixed point (s=1, nu=0)
    var = FmpcVariable(
        xs=var.xs, us=var.us, lambdas=var.lambdas,
        ss=jnp.where(gm3 > 0, var.ss, 1.0),
        nus=jnp.where(gm3 > 0, var.nus, 0.0),
    )
    n_active = jnp.maximum(jnp.sum(gms), 1.0)
    ws_valid = (jnp.all(var.ss * gm3 >= 0, axis=(0, 1))
                & jnp.all(var.nus * gm3 >= 0, axis=(0, 1)))

    impl, fwd_fused = _resolve_impls(config, dtype, ng)
    if impl == "pallas":
        from nmpc_tpu.kernels.fmpc_backward_pallas import backward_fmpc_pallas

        def backward_fn(co, ss, nus, eps):
            return backward_fmpc_pallas(problem, config, co, ss, nus, gms,
                                        eps)
    else:
        def backward_fn(co, ss, nus, eps):
            return _backward_bm(problem, config, co, ss, nus, gms, eps)

    def check(var, eps):
        """Barrier update + coefficients + KKT error (FmpcSolver.hpp:377-448),
        all batch-minor."""
        if config.update_barrier_eps:
            s_nu_ave = jnp.sum(var.ss * var.nus * gm3, axis=(0, 1)) / n_active
            eps = jnp.clip(_SIGMA * s_nu_ave, _BARRIER_EPS_MIN,
                           _BARRIER_EPS_MAX)
        co = _coeffs_bm(problem, config, t0, var)
        kkt = _kkt_error_bm(x0_b, var, co, jnp.zeros((B,), dtype), gms)
        return co, kkt, eps

    co1, kkt1, eps1 = check(var, eps)
    succeeded1 = kkt1 <= config.kkt_error_thre
    status0 = jnp.where(succeeded1, jnp.int32(FmpcStatus.SUCCEEDED),
                        jnp.int32(FmpcStatus.ITERATION_CONTINUED))
    status0 = jnp.where(ws_valid, status0,
                        jnp.int32(FmpcStatus.UNINITIALIZED))
    trace0 = jnp.zeros((B, config.max_iter + 1), dtype)
    trace0 = trace0.at[:, 1].set(jnp.where(ws_valid, kkt1, 0.0))

    state = _BState(
        steps=jnp.int32(0),
        iters=jnp.where(ws_valid, 1, 0).astype(jnp.int32),
        status=status0,
        var=var,
        co=co1,
        kkt=jnp.where(ws_valid, kkt1, jnp.inf).astype(dtype),
        ks=jnp.zeros((N, nu_dim, B), dtype),
        Ks=jnp.zeros((N, nu_dim, nx, B), dtype),
        eps=jnp.where(ws_valid, eps1, eps),
        trace_kkt=trace0,
    )

    def cond(s: _BState):
        return jnp.any(s.status == FmpcStatus.ITERATION_CONTINUED) & (
            s.steps < config.max_iter)

    def body(s: _BState):
        steps = s.steps + 1
        running = s.status == FmpcStatus.ITERATION_CONTINUED
        var = s.var
        eps = s.eps
        co = s.co

        ks, Ks, ss_vec, Ps, bw_ok, bw_finite = backward_fn(
            co, var.ss, var.nus, eps)
        bw_good = bw_ok & bw_finite
        delta, fw_finite = _forward_bm(problem, config, co, var, x0_b,
                                       ks, Ks, ss_vec, Ps, eps, gms,
                                       fused=fwd_fused)
        new_var, up_ok = _update_bm(problem, config, t0, x0_b, co, var,
                                    delta, eps, gms)

        step_status = jnp.full((B,), FmpcStatus.ITERATION_CONTINUED, jnp.int32)
        step_status = jnp.where(~up_ok, jnp.int32(FmpcStatus.ERROR_IN_UPDATE), step_status)
        step_status = jnp.where(~fw_finite, jnp.int32(FmpcStatus.ERROR_IN_FORWARD), step_status)
        step_status = jnp.where(~bw_good, jnp.int32(FmpcStatus.ERROR_IN_BACKWARD), step_status)
        status = jnp.where(running, step_status, s.status)

        advance = running & (status == FmpcStatus.ITERATION_CONTINUED)
        var_out = jax.tree_util.tree_map(
            lambda n_, o_: _bwhere_bm(advance, n_, o_), new_var, var)
        take_gains = running & bw_good
        ks_out = _bwhere_bm(take_gains, ks, s.ks)
        Ks_out = _bwhere_bm(take_gains, Ks, s.Ks)

        # next check, per-lane gated by the iteration cap
        co2, kkt2, eps2 = check(var_out, eps)
        do_check = advance & (s.iters < config.max_iter)
        iters = jnp.where(do_check, s.iters + 1, s.iters)
        succeeded = do_check & (kkt2 <= config.kkt_error_thre)
        status = jnp.where(succeeded, jnp.int32(FmpcStatus.SUCCEEDED), status)
        kkt = jnp.where(do_check, kkt2, s.kkt)
        eps_out = jnp.where(do_check, eps2, jnp.where(running, eps, s.eps))
        co_out = jax.tree_util.tree_map(
            lambda n_, o_: _bwhere_bm(do_check, n_, o_), co2, co)
        # all checking lanes share the row index steps+1 (= their iters)
        trace_kkt = s.trace_kkt.at[:, steps + 1].set(
            jnp.where(do_check, kkt2, s.trace_kkt[:, steps + 1]))

        return _BState(
            steps=steps,
            iters=iters,
            status=status,
            var=var_out,
            co=co_out,
            kkt=kkt,
            ks=ks_out, Ks=Ks_out,
            eps=eps_out,
            trace_kkt=trace_kkt,
        )

    out = lax.while_loop(cond, body, state)
    status = jnp.where(out.status == FmpcStatus.ITERATION_CONTINUED,
                       jnp.int32(FmpcStatus.MAX_ITERATION_REACHED), out.status)

    # one-time layout change back: batch-minor -> batch-first
    bf = lambda a: jnp.moveaxis(a, -1, 0)
    return FmpcResult(
        status=status,
        iters=out.iters,
        variable=jax.tree_util.tree_map(bf, out.var),
        kkt_error=out.kkt,
        ks=bf(out.ks),
        Ks=bf(out.Ks),
        barrier_eps=out.eps,
        trace=FmpcTrace(
            iter=jnp.broadcast_to(
                jnp.arange(config.max_iter + 1, dtype=jnp.int32),
                (B, config.max_iter + 1)),
            kkt_error=out.trace_kkt,
        ),
    )

