"""DDP / iLQG trajectory optimizer, batched in XLA.

Algorithmic equivalent of the reference ``nmpc_ddp::DDPSolver``
(``nmpc_ddp/include/nmpc_ddp/DDPSolver.hpp``; Tassa, Erez, Todorov IROS 2012 /
Tassa, Mansard, Todorov ICRA 2014):

  * Levenberg-Marquardt regularization with the two modes Quu+lambda*I /
    Vxx+lambda*I and the adaptive lambda schedule (``DDPSolver.hpp:191-209,
    300-333``),
  * backward Riccati-like recursion producing feedforward ``k`` and feedback
    ``K`` gains (``DDPSolver.hpp:343-534``),
  * box-constrained control via projected-Newton BoxQP with free-subspace
    feedback gains (``DDPSolver.hpp:450-497``),
  * alpha-list backtracking forward line search with expected-vs-actual
    cost-reduction acceptance (``DDPSolver.hpp:242-265``),
  * the reference's termination tests (small gradient ``:217-231``, small
    cost update ``:289-298``, max-iter ``:116``) and failure modes (lambda
    overflow in backward retry / forward reject).

Batched redesign
----------------
* The derivative sweep is one vmapped autodiff evaluation over all N stages
  (reference: N sequential virtual calls, ``DDPSolver.hpp:160-178``).
* The backward pass is a ``lax.scan``; batched solves add a leading vmap axis
  so every per-stage op becomes a batched small-matrix kernel.
* The 11 forward line-search alphas are rolled out **in parallel** as an
  extra vmap axis and the first acceptable one is selected — identical
  accept decision to the reference's serial early-exit loop, at 1/11th the
  latency-bound depth.
* Data-dependent control flow (lambda retry, iteration loop) is
  ``lax.while_loop``; under vmap, lanes converge independently (masked), so
  one diverging problem cannot abort a batch — per-lane ``status`` replaces
  the reference's exceptions/bool returns.
* Time-varying input dimension becomes static max-dim padding + masks (see
  core/problem.py); fully-masked stages reproduce the reference's
  ``input_dim == 0`` branch (``DDPSolver.hpp:513-517``) exactly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from nmpc_tpu.core.problem import Problem
from nmpc_tpu.core.types import DDPConfig, DDPResult, DDPStatus, DDPTrace
from nmpc_tpu.kernels.linalg import cho_solve_small, cholesky_small
from nmpc_tpu.solvers.boxqp import boxqp_solve
from nmpc_tpu.utils.precision import full_precision


class _StageDerivs(NamedTuple):
    Fx: jnp.ndarray
    Fu: jnp.ndarray
    Lx: jnp.ndarray
    Lu: jnp.ndarray
    Lxx: jnp.ndarray
    Luu: jnp.ndarray
    Lxu: jnp.ndarray
    # second-order dynamics (zeros unless enabled)
    Fxx: jnp.ndarray
    Fuu: jnp.ndarray
    Fxu: jnp.ndarray
    mask: jnp.ndarray       # active-input mask [nu]
    lower: jnp.ndarray      # box bounds (used when with_input_constraint)
    upper: jnp.ndarray
    u: jnp.ndarray          # current input (bounds are relative to it)


class DDPSolver:
    """Factory wrapping a problem+config into jitted solve functions."""

    def __init__(self, problem: Problem, config: DDPConfig = DDPConfig()):
        self.problem = problem
        self.config = config
        if (config.deriv_dtype == "float64"
                and not jax.config.jax_enable_x64):
            raise ValueError(
                "DDPConfig.deriv_dtype='float64' requires jax_enable_x64 "
                "(jax.config.update('jax_enable_x64', True)); without it "
                "the fp64 derivative islands would silently run in fp32")
        # raw (unjitted) single-solve function; reused by the distributed
        # layer to re-jit with explicit shardings (parallel/mesh.py).
        self.raw_solve = full_precision(
            functools.partial(_solve, problem, config))
        # Batched solve: batch-minor end to end; on a GPU the backward and
        # the selected-alpha rollout run as fused kernels
        # (_resolve_backward_impl / _resolve_forward_fused), elsewhere the
        # stacked XLA kernels (kernels/ddp_backward.py).
        self.raw_solve_batch = full_precision(
            functools.partial(_solve_stacked, problem, config))
        self._solve = jax.jit(self.raw_solve)
        self._solve_batch = jax.jit(self.raw_solve_batch)

    def solve(self, t0, x0, us_init) -> DDPResult:
        """One solve. Reference: ``DDPSolver::solve`` (``DDPSolver.hpp:27``)."""
        return self._solve(t0, x0, us_init)

    def solve_batch(self, t0, x0s, us_inits) -> DDPResult:
        """vmapped solve over a leading batch axis of initial states/guesses."""
        return self._solve_batch(t0, x0s, us_inits)


# --------------------------------------------------------------------------
# implementation
# --------------------------------------------------------------------------


def _rollout(problem: Problem, config: DDPConfig, t0, x0, us):
    """Initial trajectory rollout (``DDPSolver.hpp:87-95``)."""
    N = config.horizon_steps
    ts = t0 + problem.dt * jnp.arange(N, dtype=x0.dtype)

    def step(x, tu):
        t, u = tu
        # Cast at the user-callback boundary: model constants may be wider
        # than the solve dtype and must not promote the whole solve.
        xn = problem.dynamics(t, x, u).astype(x.dtype)
        c = problem.running_cost(t, x, u).astype(x.dtype)
        return xn, (xn, c)

    _, (xs_tail, cs) = lax.scan(step, x0, (ts, us))
    xs = jnp.concatenate([x0[None], xs_tail], axis=0)
    c_term = problem.terminal_cost(t0 + N * problem.dt, xs[-1]).astype(xs.dtype)
    costs = jnp.concatenate([cs, c_term[None]])
    return xs, costs


def _deriv_dtype_of(config: DDPConfig, dtype):
    """Resolve DDPConfig.deriv_dtype against the solve dtype (mixed
    precision: fp64 derivative islands inside an fp32 solve)."""
    if config.deriv_dtype == "same":
        return dtype
    return jnp.dtype(config.deriv_dtype)


def _stage_derivs(problem: Problem, config: DDPConfig, t, x, u) -> _StageDerivs:
    dtype = x.dtype
    nx, nu = problem.state_dim, problem.input_dim
    # mixed precision: evaluate the derivative callables at deriv_dtype
    # (cast up at the callback boundary), then cast results back down —
    # everything downstream stays at the solve dtype
    ddt = _deriv_dtype_of(config, dtype)
    td, xd, ud = jnp.asarray(t, ddt), x.astype(ddt), u.astype(ddt)
    # boundary cast: derivatives of fp64-weighted models must enter the
    # backward pass at the solve dtype
    Fx, Fu = (a.astype(dtype) for a in problem.linearize_dynamics(td, xd, ud))
    Lx, Lu, Lxx, Luu, Lxu = (
        a.astype(dtype)
        for a in problem.quadraticize_running_cost(td, xd, ud))

    if config.use_state_eq_second_derivative:
        Fxx, Fuu, Fxu = (
            a.astype(dtype)
            for a in problem.second_order_dynamics(td, xd, ud))
    else:
        Fxx = jnp.zeros((nx, nx, nx), dtype)
        Fuu = jnp.zeros((nx, nu, nu), dtype)
        Fxu = jnp.zeros((nx, nx, nu), dtype)

    mask = problem.input_mask_at(t).astype(dtype)
    if problem.input_mask is not None:
        # Masked-dimension embedding: zero inactive columns, unit diagonal on
        # the inactive Luu block so Quu stays PD and yields k=0, K-row=0 for
        # inactive inputs — the reference's variable-dim solve embedded in
        # the padded space (DDPProblem.h:74-85, DDPSolver.hpp:513-517).
        Fu = Fu * mask[None, :]
        Lu = Lu * mask
        Luu = Luu * (mask[:, None] * mask[None, :]) + jnp.diag(1.0 - mask)
        Lxu = Lxu * mask[None, :]
        Fuu = Fuu * (mask[None, :, None] * mask[None, None, :])
        Fxu = Fxu * mask[None, None, :]

    if problem.input_limits is not None:
        lower, upper = problem.input_limits(t)
        lower = jnp.asarray(lower, dtype)
        upper = jnp.asarray(upper, dtype)
        if problem.input_mask is not None:
            # Inactive dims get harmless (-1, 1) bounds around 0.
            lower = jnp.where(mask > 0, lower, -jnp.ones_like(lower))
            upper = jnp.where(mask > 0, upper, jnp.ones_like(upper))
    else:
        lower = jnp.full((nu,), -jnp.inf, dtype)
        upper = jnp.full((nu,), jnp.inf, dtype)

    return _StageDerivs(Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, Fxx, Fuu, Fxu,
                        mask, lower, upper, u)


def _derivative_sweep(problem, config, t0, xs, us):
    """Vmapped stage derivatives + terminal expansion (``DDPSolver.hpp:156-185``)."""
    N = config.horizon_steps
    ts = t0 + problem.dt * jnp.arange(N, dtype=xs.dtype)
    D = jax.vmap(lambda t, x, u: _stage_derivs(problem, config, t, x, u))(
        ts, xs[:-1], us
    )
    ddt = _deriv_dtype_of(config, xs.dtype)
    Vx_T, Vxx_T = (a.astype(xs.dtype) for a in
                   problem.quadraticize_terminal_cost(
                       jnp.asarray(t0 + N * problem.dt, ddt),
                       xs[-1].astype(ddt)))
    return D, Vx_T, Vxx_T


def _backward(problem: Problem, config: DDPConfig, D: _StageDerivs, Vx_T, Vxx_T, lam):
    """Backward pass (``DDPSolver.hpp:343-534``). Returns (ks, Ks, dV, ok)."""
    dtype = Vx_T.dtype
    nx, nu = problem.state_dim, problem.input_dim
    eye_nu = jnp.eye(nu, dtype=dtype)
    boxed = config.with_input_constraint

    def bstep(carry, d: _StageDerivs):
        Vx, Vxx, dV, ok, k_next = carry

        Qu = d.Lu + d.Fu.T @ Vx
        Qx = d.Lx + d.Fx.T @ Vx
        Qux = d.Lxu.T + d.Fu.T @ Vxx @ d.Fx
        Quu = d.Luu + d.Fu.T @ Vxx @ d.Fu
        Qxx = d.Lxx + d.Fx.T @ Vxx @ d.Fx
        if config.use_state_eq_second_derivative:
            # Full-DDP curvature terms Vx . Fab — declared but unimplemented
            # in the reference (DDPSolver.hpp:391-414); delivered via autodiff.
            VxFxu = jnp.einsum("i,ijk->jk", Vx, d.Fxu)   # [nx, nu]
            VxFuu = jnp.einsum("i,ijk->jk", Vx, d.Fuu)   # [nu, nu]
            VxFxx = jnp.einsum("i,ijk->jk", Vx, d.Fxx)   # [nx, nx]
            Qux = Qux + VxFxu.T
            Quu = Quu + VxFuu
            Qxx = Qxx + VxFxx

        # Regularization (DDPSolver.hpp:419-441).
        Vxx_reg = Vxx + (lam if config.reg_type == 2 else 0.0) * jnp.eye(nx, dtype=dtype)
        Qux_reg = d.Lxu.T + d.Fu.T @ Vxx_reg @ d.Fx
        Quu_F = d.Luu + d.Fu.T @ Vxx_reg @ d.Fu
        if config.use_state_eq_second_derivative:
            Qux_reg = Qux_reg + VxFxu.T
            Quu_F = Quu_F + VxFuu
        if config.reg_type == 1:
            Quu_F = Quu_F + lam * eye_nu

        if boxed:
            # Constrained gains via BoxQP on Quu_F with bounds relative to the
            # current input, warm-started from the next stage's feedforward
            # (DDPSolver.hpp:450-497).
            qp = boxqp_solve(
                Quu_F, Qu, d.lower - d.u, d.upper - d.u, k_next, config.boxqp
            )
            ok_i = qp.status >= 0
            k = qp.x
            fm = qp.free_mask.astype(dtype)
            # K rows: free rows solve H_free K_free = -Qux_reg_free using the
            # masked factorization; clamped rows are zero (DDPSolver.hpp:482-496).
            rhs = fm[:, None] * Qux_reg
            K = -fm[:, None] * cho_solve_small(qp.chol, rhs)
        else:
            L, ok_i = cholesky_small(Quu_F)
            k = -cho_solve_small(L, Qu)
            K = -cho_solve_small(L, Qux_reg)

        # Value-function update with the *unregularized* Q terms
        # (DDPSolver.hpp:522-526).
        dV = dV + jnp.stack([k @ Qu, 0.5 * k @ (Quu @ k)])
        Vx_new = Qx + K.T @ (Quu @ k) + K.T @ Qu + Qux.T @ k
        Vxx_new = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)

        return (Vx_new, Vxx_new, dV, ok & ok_i, k), (k, K)

    init = (
        Vx_T,
        Vxx_T,
        jnp.zeros((2,), dtype),
        jnp.bool_(True),
        jnp.zeros((nu,), dtype),
    )
    (_, _, dV, ok, _), (ks, Ks) = lax.scan(bstep, init, D, reverse=True)
    return ks, Ks, dV, ok


def _backward_with_retry(problem, config, D, Vx_T, Vxx_T, lam, dlam, ks0, Ks0):
    """Backward pass with the lambda-increase retry loop (``DDPSolver.hpp:191-209``).

    Returns (lam, dlam, ks, Ks, dV, ok, failed): on failure (lambda overflow)
    the previous gains are preserved, matching the reference's early return.
    """
    dtype = Vx_T.dtype
    ks, Ks, dV, ok = _backward(problem, config, D, Vx_T, Vxx_T, lam)
    ks = jnp.where(ok, ks, ks0)
    Ks = jnp.where(ok, Ks, Ks0)

    def cond(c):
        lam_, dlam_, ks_, Ks_, dV_, ok_, failed_, n_ = c
        return (~ok_) & (~failed_) & (n_ < config.max_backward_retries)

    def body(c):
        lam_, dlam_, ks_, Ks_, dV_, ok_, failed_, n_ = c
        dlam_ = jnp.maximum(dlam_ * config.lambda_factor, config.lambda_factor)
        lam_ = jnp.maximum(lam_ * dlam_, config.lambda_min)
        failed_ = lam_ > config.lambda_max
        ks2, Ks2, dV2, ok2 = _backward(problem, config, D, Vx_T, Vxx_T, lam_)
        ok2 = ok2 & (~failed_)
        ks_ = jnp.where(ok2, ks2, ks_)
        Ks_ = jnp.where(ok2, Ks2, Ks_)
        dV_ = jnp.where(ok2, dV2, dV_)
        return (lam_, dlam_, ks_, Ks_, dV_, ok2, failed_, n_ + 1)

    lam, dlam, ks, Ks, dV, ok, failed, _ = lax.while_loop(
        cond, body, (lam, dlam, ks, Ks, dV, ok, jnp.bool_(False), jnp.int32(0))
    )
    return lam, dlam, ks, Ks, dV, ok, failed


def _forward_all_alphas(problem, config, t0, xs, us, ks, Ks):
    """Roll out every line-search alpha in parallel (``DDPSolver.hpp:537-560``).

    Returns per-alpha candidate (xs, us, costs) stacked on a leading axis.
    """
    N = config.horizon_steps
    dtype = xs.dtype
    ts = t0 + problem.dt * jnp.arange(N, dtype=dtype)
    alphas = jnp.asarray(config.alpha_list, dtype)

    def one_alpha(alpha):
        def step(x, inp):
            t, x_ref, u_ref, k, K = inp
            u = u_ref + alpha * k + K @ (x - x_ref)
            xn = problem.dynamics(t, x, u).astype(dtype)
            c = problem.running_cost(t, x, u).astype(dtype)
            return xn, (xn, u, c)

        _, (xs_tail, us_new, cs) = lax.scan(step, xs[0], (ts, xs[:-1], us, ks, Ks))
        xs_new = jnp.concatenate([xs[0][None], xs_tail], axis=0)
        c_term = problem.terminal_cost(t0 + N * problem.dt, xs_new[-1]).astype(dtype)
        costs = jnp.concatenate([cs, c_term[None]])
        return xs_new, us_new, costs

    return jax.vmap(one_alpha)(alphas)


class _SolveState(NamedTuple):
    it: jnp.ndarray
    status: jnp.ndarray
    xs: jnp.ndarray
    us: jnp.ndarray
    costs: jnp.ndarray
    ks: jnp.ndarray
    Ks: jnp.ndarray
    lam: jnp.ndarray
    dlam: jnp.ndarray
    trace: DDPTrace


def _solve(problem: Problem, config: DDPConfig, t0, x0, us_init) -> DDPResult:
    """Full DDP solve (``DDPSolver::solve``, ``DDPSolver.hpp:27-141``)."""
    dtype = x0.dtype
    t0 = jnp.asarray(t0, dtype)
    N = config.horizon_steps
    nx, nu = problem.state_dim, problem.input_dim
    assert us_init.shape == (N, nu), (
        f"initial_u_list must have shape {(N, nu)}, got {us_init.shape}"
    )
    n_trace = config.max_iter + 1

    xs, costs = _rollout(problem, config, t0, x0, us_init)

    def zeros(shape=()):
        return jnp.zeros(shape, dtype)

    trace = DDPTrace(
        iter=jnp.arange(n_trace, dtype=jnp.int32),
        cost=zeros((n_trace,)).at[0].set(jnp.sum(costs)),
        lam=zeros((n_trace,)).at[0].set(config.initial_lambda),
        dlam=zeros((n_trace,)).at[0].set(config.initial_dlambda),
        alpha=zeros((n_trace,)),
        k_rel_norm=zeros((n_trace,)),
        cost_update_actual=zeros((n_trace,)),
        cost_update_expected=zeros((n_trace,)),
        cost_update_ratio=zeros((n_trace,)),
    )

    state = _SolveState(
        it=jnp.int32(0),
        status=jnp.int32(DDPStatus.RUNNING),
        xs=xs,
        us=us_init,
        costs=costs,
        ks=zeros((N, nu)),
        Ks=zeros((N, nu, nx)),
        lam=jnp.asarray(config.initial_lambda, dtype),
        dlam=jnp.asarray(config.initial_dlambda, dtype),
        trace=trace,
    )

    def cond(s: _SolveState):
        return s.status == DDPStatus.RUNNING

    def body(s: _SolveState):
        it = s.it + 1

        # Step 1: derivative sweep along the current trajectory.
        D, Vx_T, Vxx_T = _derivative_sweep(problem, config, t0, s.xs, s.us)

        # Step 2: backward pass with lambda retry.
        lam, dlam, ks, Ks, dV, bw_ok, bw_failed = _backward_with_retry(
            problem, config, D, Vx_T, Vxx_T, s.lam, s.dlam, s.ks, s.Ks
        )
        status = jnp.where(
            bw_failed, jnp.int32(DDPStatus.FAIL_BACKWARD_LAMBDA),
            jnp.int32(DDPStatus.RUNNING),
        )

        # Small-gradient termination (DDPSolver.hpp:217-231).
        k_rel_norm = jnp.max(
            jnp.linalg.norm(ks, axis=-1) / (jnp.linalg.norm(s.us, axis=-1) + 1.0)
        )
        term_grad = (
            (status == DDPStatus.RUNNING)
            & (k_rel_norm < config.k_rel_norm_thre)
            & (lam < config.lambda_thre)
        )
        status = jnp.where(term_grad, jnp.int32(DDPStatus.SUCCEEDED), status)

        # Step 3: forward pass, all alphas in parallel (DDPSolver.hpp:242-265).
        cand_xs, cand_us, cand_costs = _forward_all_alphas(
            problem, config, t0, s.xs, s.us, ks, Ks
        )
        alphas = jnp.asarray(config.alpha_list, dtype)
        cost_old = jnp.sum(s.costs)
        cand_sums = jnp.sum(cand_costs, axis=-1)
        actual = cost_old - cand_sums
        expected = -alphas * (dV[0] + alphas * dV[1])
        ratio_raw = actual / expected
        # Reference: when expected < 0, ratio := sign(actual) (DDPSolver.hpp:251-259).
        ratio = jnp.where(expected < 0, jnp.where(actual >= 0, 1.0, -1.0), ratio_raw)
        accept_mask = ratio > config.cost_update_ratio_thre
        fw_success = jnp.any(accept_mask)
        first_idx = jnp.argmax(accept_mask)  # first True in alpha order
        idx = jnp.where(fw_success, first_idx, len(config.alpha_list) - 1)

        do_forward = status == DDPStatus.RUNNING
        accept = do_forward & fw_success

        xs = jnp.where(accept, cand_xs[idx], s.xs)
        us = jnp.where(accept, cand_us[idx], s.us)
        costs = jnp.where(accept, cand_costs[idx], s.costs)

        # Step 4: accept / reject, lambda schedule (DDPSolver.hpp:280-333).
        term_cost = accept & (actual[idx] < config.cost_update_thre)
        status = jnp.where(term_cost, jnp.int32(DDPStatus.SUCCEEDED), status)

        dlam_acc = jnp.minimum(dlam / config.lambda_factor, 1.0 / config.lambda_factor)
        lam_acc = jnp.where(lam >= config.lambda_min, lam * dlam_acc, 0.0)
        dlam_rej = jnp.maximum(dlam * config.lambda_factor, config.lambda_factor)
        lam_rej = jnp.maximum(lam * dlam_rej, config.lambda_min)

        reject = do_forward & ~fw_success
        lam = jnp.where(accept, lam_acc, jnp.where(reject, lam_rej, lam))
        dlam = jnp.where(accept, dlam_acc, jnp.where(reject, dlam_rej, dlam))
        status = jnp.where(
            reject & (lam > config.lambda_max),
            jnp.int32(DDPStatus.FAIL_FORWARD_LAMBDA), status,
        )

        # Trace row (fields filled only along the path reached, like the
        # reference's progressively-filled TraceData).
        tr = s.trace
        reached_fwd = do_forward
        tr = DDPTrace(
            iter=tr.iter,
            cost=tr.cost.at[it].set(jnp.where(reached_fwd, jnp.sum(costs), 0.0)),
            lam=tr.lam.at[it].set(jnp.where(reached_fwd, lam, 0.0)),
            dlam=tr.dlam.at[it].set(jnp.where(reached_fwd, dlam, 0.0)),
            alpha=tr.alpha.at[it].set(jnp.where(reached_fwd, alphas[idx], 0.0)),
            k_rel_norm=tr.k_rel_norm.at[it].set(
                jnp.where(~bw_failed, k_rel_norm, 0.0)
            ),
            cost_update_actual=tr.cost_update_actual.at[it].set(
                jnp.where(reached_fwd, actual[idx], 0.0)
            ),
            cost_update_expected=tr.cost_update_expected.at[it].set(
                jnp.where(reached_fwd, expected[idx], 0.0)
            ),
            cost_update_ratio=tr.cost_update_ratio.at[it].set(
                jnp.where(reached_fwd, ratio[idx], 0.0)
            ),
        )

        status = jnp.where(
            (status == DDPStatus.RUNNING) & (it >= config.max_iter),
            jnp.int32(DDPStatus.MAX_ITER_REACHED), status,
        )

        # print_level diagnostics (reference DDPSolver.hpp:106-109,198-207)
        from nmpc_tpu.utils.logging import log, log_when

        log(config.print_level, 3,
            "[DDP] iter {it}: cost {cost:.6e} lambda {lam:.3e} "
            "alpha {alpha:.3e} k_rel_norm {krn:.3e}",
            it=it, cost=jnp.sum(costs), lam=lam, alpha=alphas[idx],
            krn=k_rel_norm)
        log_when(config.print_level, 1, bw_failed,
                 "[DDP/Warning] Failure in backward pass: lambda exceeded "
                 "lambda_max (iter {it})", it=it)
        log_when(config.print_level, 1,
                 status == DDPStatus.FAIL_FORWARD_LAMBDA,
                 "[DDP/Warning] Failure in forward pass: lambda exceeded "
                 "lambda_max (iter {it})", it=it)

        return _SolveState(
            it=it, status=status, xs=xs, us=us, costs=costs,
            ks=ks, Ks=Ks, lam=lam, dlam=dlam, trace=tr,
        )

    out = lax.while_loop(cond, body, state)

    return DDPResult(
        status=out.status,
        success=out.status == DDPStatus.SUCCEEDED,
        iters=out.it,
        xs=out.xs,
        us=out.us,
        costs=out.costs,
        ks=out.ks,
        Ks=out.Ks,
        lam=out.lam,
        dlam=out.dlam,
        trace=out.trace,
    )


# --------------------------------------------------------------------------
# natively-batched solve (batch-minor backward kernel)
# --------------------------------------------------------------------------


def _rollout_lanes(problem, config, t0, x_l, us_l):
    """Initial rollout, lane-blocked: x_l [nx, S, L], us_l [N, nu, S, L]
    -> (xs_l [N+1, nx, S, L], costs_l [N+1, S, L]).  User dynamics/cost are
    double-vmapped over (S, 128) lane blocks (kernels/lanes.py)."""
    from nmpc_tpu.kernels.lanes import vmap_lanes

    N = config.horizon_steps
    dtype = x_l.dtype
    ts = t0 + problem.dt * jnp.arange(N, dtype=dtype)

    dyn2 = vmap_lanes(problem.dynamics, 2)
    cost2 = vmap_lanes(problem.running_cost, 2)
    term2 = vmap_lanes(problem.terminal_cost, 1)

    def step(x, tu):
        t, u = tu
        # boundary cast: wide model constants must not promote the solve
        xn = dyn2(t, x, u).astype(dtype)
        c = cost2(t, x, u).astype(dtype)
        return xn, (xn, c)

    xN, (xs_tail, cs) = lax.scan(step, x_l, (ts, us_l))
    c_term = term2(t0 + N * problem.dt, xN).astype(dtype)
    xs_l = jnp.concatenate([x_l[None], xs_tail], axis=0)   # [N+1, nx, S, L]
    costs_l = jnp.concatenate([cs, c_term[None]], axis=0)  # [N+1, S, L]
    return xs_l, costs_l


def _rollout_stacked(problem, config, t0, x0s, us):
    """Batch-first wrapper of :func:`_rollout_lanes`: x0s [B, nx],
    us [B, N, nu] -> (xs [B, N+1, nx], costs [B, N+1])."""
    from nmpc_tpu.kernels.lanes import block_lanes, lane_factors, unblock_lanes

    S, L = lane_factors(x0s.shape[0])
    xs_l, costs_l = _rollout_lanes(problem, config, t0,
                                   block_lanes(x0s, 0, S, L),
                                   block_lanes(us, 0, S, L))
    return unblock_lanes(xs_l, 0), unblock_lanes(costs_l, 0)


def _terminal_quad_lanes(problem, config, t0, xs_l):
    """Terminal cost expansion, lane-blocked: (Vx_T [nx, S, L],
    Vxx_T [nx, nx, S, L]).  Shared by the sweep-fed path and the remat
    path (which needs ONLY this — stage derivatives are recomputed
    in-kernel)."""
    from nmpc_tpu.kernels.lanes import vmap_lanes

    N = config.horizon_steps
    ddt = _deriv_dtype_of(config, xs_l.dtype)
    term2 = vmap_lanes(problem.quadraticize_terminal_cost, 1)
    Vx_T, Vxx_T = (a.astype(xs_l.dtype)
                   for a in term2(jnp.asarray(t0 + N * problem.dt, ddt),
                                  xs_l[-1].astype(ddt)))
    return Vx_T, Vxx_T


def _derivative_sweep_lanes(problem, config, t0, xs_l, us_l):
    """Derivative sweep producing batch-minor stage derivatives natively:
    every leaf is [N, small_dims..., S, L] — zero layout transposes between
    the (vmapped autodiff) sweep and the stacked backward kernel.
    Terminal expansion: (Vx_T [nx, S, L], Vxx_T [nx, nx, S, L])."""
    from nmpc_tpu.kernels.lanes import vmap_lanes

    N = config.horizon_steps
    ts = t0 + problem.dt * jnp.arange(N, dtype=xs_l.dtype)
    f2 = vmap_lanes(lambda t, x, u: _stage_derivs(problem, config, t, x, u), 2)
    D = jax.vmap(f2, in_axes=(0, 0, 0))(ts, xs_l[:-1], us_l)
    Vx_T, Vxx_T = _terminal_quad_lanes(problem, config, t0, xs_l)
    return D, Vx_T, Vxx_T


def _ls_cost_dtype(problem, config, ts, xs_l, us_l):
    """Accumulator dtype for line-search cost sums: follows the cost
    function's output (it may promote, e.g. fp32 states with fp64 weights
    under x64) widened by deriv_dtype — fp32 cost sums (~300 at fp32 eps)
    put ~2e-5 noise into the alpha acceptance comparisons, a measurable
    slice of the fp32 u-parity floor.  Shared by the all-alphas sweep and
    the selected-alpha rollout so every path accumulates identically."""
    cdtype = jax.eval_shape(
        problem.running_cost, ts[0], xs_l[0, :, 0, 0], us_l[0, :, 0, 0]).dtype
    return jnp.promote_types(cdtype, _deriv_dtype_of(config, xs_l.dtype))


def _forward_costs_lanes(problem, config, t0, xs_l, us_l, ks_l, Ks_l,
                         alphas_override=None):
    """Cost-only line-search rollout, all alphas at once (batched redesign of
    the reference's serial alpha loop, ``DDPSolver.hpp:242-265,537-560``).

    Alpha lives on a small LEADING axis of the scan carry, so the per-stage
    references (x_ref, u_ref, k, K) are streamed from HBM once — not
    materialized ``A = len(alpha_list)`` times — and nothing per-stage is
    written back: the scan carries only (x [A,nx,S,L], cost_acc [A,S,L]).
    The accepted trajectory is re-rolled once by
    :func:`_forward_selected_lanes` (bitwise-identical lane math).

    ``alphas_override`` evaluates a subset of the schedule (the head/tail
    split in ``_solve_stacked``: the full sweep only runs for iterations
    where some lane rejects alpha[0]).

    xs_l [N+1, nx, S, L], us_l/ks_l [N, nu, S, L], Ks_l [N, nu, nx, S, L].
    Returns per-alpha total costs [A, S, L].
    """
    from nmpc_tpu.kernels.lanes import vmap_lanes

    N = config.horizon_steps
    dtype = xs_l.dtype
    S, L = xs_l.shape[-2:]
    alphas = (jnp.asarray(config.alpha_list, dtype)
              if alphas_override is None
              else jnp.asarray(alphas_override, dtype))
    A = alphas.shape[0]
    ts = t0 + problem.dt * jnp.arange(N, dtype=dtype)

    dyn2 = vmap_lanes(problem.dynamics, 2)
    cost2 = vmap_lanes(problem.running_cost, 2)
    term2 = vmap_lanes(problem.terminal_cost, 1)
    # extra vmap over the leading alpha axis of (x, u)
    dyn3 = jax.vmap(dyn2, in_axes=(None, 0, 0))
    cost3 = jax.vmap(cost2, in_axes=(None, 0, 0))
    term3 = jax.vmap(term2, in_axes=(None, 0))

    a_bc = alphas[:, None, None, None]          # [A, 1, 1, 1]

    cdtype = _ls_cost_dtype(problem, config, ts, xs_l, us_l)

    def step(carry, inp):
        x, ctot = carry                         # [A, nx, S, L], [A, S, L]
        t, xr, ur, k, K = inp
        dx = x - xr[None]                       # [A, nx, S, L]
        u = (ur[None] + a_bc * k[None]
             + jnp.sum(K[None] * dx[:, None], axis=2))   # [A, nu, S, L]
        xn = dyn3(t, x, u).astype(dtype)
        c = cost3(t, x, u).astype(cdtype)
        return (xn, ctot + c), None

    x0A = jnp.broadcast_to(xs_l[0][None], (A,) + xs_l[0].shape)
    ct0 = jnp.zeros((A, S, L), cdtype)
    (xN, ctot), _ = lax.scan(
        step, (x0A, ct0), (ts, xs_l[:-1], us_l, ks_l, Ks_l))
    return ctot + term3(t0 + N * problem.dt, xN).astype(cdtype)  # [A, S, L]


def _forward_selected_lanes(problem, config, t0, xs_l, us_l, ks_l, Ks_l,
                            alpha_l):
    """Roll out the per-lane selected alpha once, producing the new
    trajectory and per-stage costs (``DDPSolver.hpp:537-560``).

    alpha_l [S, L].  Returns (xs_l [N+1,nx,S,L], us_l [N,nu,S,L],
    costs_l [N+1,S,L], cost_sum [S,L] in the line-search accumulator
    dtype).  ``cost_sum`` is accumulated inside the scan exactly like
    ``_forward_costs_lanes``' per-alpha sums (same values — the cost enters
    at its native dtype, is cast to cdtype, then added in horizon order),
    so head-path alpha[0] acceptance compares bit-identically against
    sweep-path sums at any precision.
    """
    from nmpc_tpu.kernels.lanes import vmap_lanes

    N = config.horizon_steps
    dtype = xs_l.dtype
    ts = t0 + problem.dt * jnp.arange(N, dtype=dtype)
    cdtype = _ls_cost_dtype(problem, config, ts, xs_l, us_l)

    dyn2 = vmap_lanes(problem.dynamics, 2)
    cost2 = vmap_lanes(problem.running_cost, 2)
    term2 = vmap_lanes(problem.terminal_cost, 1)

    def step(carry, inp):
        x, ctot = carry
        t, xr, ur, k, K = inp
        dx = x - xr
        u = ur + alpha_l[None] * k + jnp.sum(K * dx[None, :], axis=1)
        xn = dyn2(t, x, u).astype(dtype)
        c_raw = cost2(t, x, u)
        return (xn, ctot + c_raw.astype(cdtype)), (xn, u, c_raw.astype(dtype))

    ct0 = jnp.zeros(xs_l.shape[-2:], cdtype)
    (xN, ctot), (xs_tail, us_new, cs) = lax.scan(
        step, (xs_l[0], ct0), (ts, xs_l[:-1], us_l, ks_l, Ks_l))
    c_term_raw = term2(t0 + N * problem.dt, xN)
    xs_all = jnp.concatenate([xs_l[0][None], xs_tail], axis=0)
    costs_all = jnp.concatenate([cs, c_term_raw.astype(dtype)[None]], axis=0)
    return xs_all, us_new, costs_all, ctot + c_term_raw.astype(cdtype)


def _resolve_backward_impl(config: DDPConfig, problem: Problem, dtype,
                           boxed: bool, second: bool) -> str:
    """Static backward-kernel choice for the batched solve — the one place
    holding the ``auto`` rule (see ``DDPConfig.backward_impl``).

    ``auto`` on a GPU, for fp32 first-order solves, prefers:
      1. "remat" — the fused kernel fed by the trajectory, stage
         derivatives recomputed in-kernel (no derivative sweep, no stage
         derivative buffer).  Needs ``deriv_dtype == "same"`` and problem
         callbacks the tile interpreter supports.
      2. "pallas" — derivative sweep + fused backward kernel.
    and "stacked", the batch-minor XLA kernel, everywhere else.  Boxed
    solves also need nu <= 2: the in-kernel BoxQP fully unrolls nu x nu
    Cholesky and Armijo blocks per lane, so the kernel's code grows ~nu^3
    and its compile time with it.  On an H100 the boxed solve with the
    kernel compiles at nu=2 (vertical motion) inside the 91 s of
    ``chip_smoke.py``'s boxed phase, stacked solves included, but had not
    compiled after 7 minutes at nu=8 (B=256, N=100), where the stacked
    solve runs at 0.91 s.  Widths 3-7 are unmeasured and keep the stacked kernel,
    whose while-loop BoxQP compiles at any width.
    """
    impl = config.backward_impl
    if impl != "auto":
        return impl
    from nmpc_tpu.kernels.lane_kernel import on_gpu

    eligible = (on_gpu()
                and jnp.dtype(dtype) == jnp.float32
                and not second)
    if boxed:
        eligible = eligible and problem.input_dim <= 2
    if not eligible:
        return "stacked"
    if config.deriv_dtype == "same":
        from nmpc_tpu.kernels.ddp_backward_remat import remat_supported

        if remat_supported(problem, problem.state_dim, problem.input_dim,
                           boxed):
            return "remat"
    return "pallas"


def _resolve_forward_fused(config: DDPConfig, problem: Problem, dtype,
                           cdtype) -> bool:
    """Whether the selected-alpha rollout runs as the fused Pallas kernel
    (``DDPConfig.forward_impl``).  The kernel accumulates cost sums in
    horizon order at the solve dtype, so the line search's accept contract
    needs ``cdtype == dtype``, and the rollout callables must
    tile-interpret.  The all-alphas cost sweep always stays on the scan:
    it is A x the rollout work in one batched scan."""
    if config.forward_impl == "scan":
        return False
    from nmpc_tpu.kernels.ddp_forward_remat import forward_remat_supported
    from nmpc_tpu.kernels.lane_kernel import on_gpu, require_kernels

    nx, nu = problem.state_dim, problem.input_dim
    fwd_ok = (cdtype == dtype
              and forward_remat_supported(problem, nx, nu,
                                          jnp.dtype(dtype).name))
    if config.forward_impl == "fused":
        require_kernels("forward_impl='fused'")
        assert fwd_ok, (
            "forward_impl='fused' requires cost sums at the solve dtype "
            "and tile-interpretable dynamics / cost / terminal-cost "
            "callables")
        return True
    return fwd_ok and on_gpu() and jnp.dtype(dtype) == jnp.float32


def _make_backward_fn(config: DDPConfig, impl: str, Dst, VxT_s, VxxT_s,
                      bounds=None, D2=None):
    """Bind the chosen sweep-fed backward kernel to its derivative data:
    returns ``backward_fn(lam) -> (ks, Ks, dV, ok)`` (batch-minor).
    (The "remat" impl is trajectory-fed and bound in ``_solve_stacked``.)
    """
    if impl == "pallas" and D2 is not None:
        raise ValueError("backward_impl='pallas' is first-order only "
                         "(use_state_eq_second_derivative needs 'stacked')")
    if bounds is not None:
        if impl == "pallas":
            from nmpc_tpu.kernels.ddp_backward_pallas import (
                backward_pallas_boxed)

            return lambda lam: backward_pallas_boxed(config, Dst, bounds,
                                                     VxT_s, VxxT_s, lam)
        from nmpc_tpu.kernels.ddp_backward import backward_stacked_boxed

        return lambda lam: backward_stacked_boxed(config, Dst, bounds,
                                                  VxT_s, VxxT_s, lam, D2=D2)
    if impl == "pallas":
        from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas

        return lambda lam: backward_pallas(config, Dst, VxT_s, VxxT_s, lam)
    from nmpc_tpu.kernels.ddp_backward import backward_stacked

    return lambda lam: backward_stacked(config, Dst, VxT_s, VxxT_s, lam,
                                        D2=D2)


def _backward_retry(config, backward_fn, lam, dlam, ks0_s, Ks0_s, running):
    """Per-lane lambda-retry loop around a bound backward kernel.

    Semantics per lane match ``_backward_with_retry`` under vmap
    (``DDPSolver.hpp:191-209``): a lane whose backward fails bumps its own
    lambda and retries; converged/non-running lanes are frozen.
    All stacked quantities carry batch on the LAST axis.
    """
    B = lam.shape[0]
    dtype = lam.dtype

    ks, Ks, dV, ok = backward_fn(lam)
    ok_all = ok | ~running
    ks = jnp.where(ok[None, None, :], ks, ks0_s)
    Ks = jnp.where(ok[None, None, None, :], Ks, Ks0_s)

    def cond(c):
        lam_, dlam_, ks_, Ks_, dV_, ok_, failed_, n_ = c
        return jnp.any(~ok_ & ~failed_) & (n_ < config.max_backward_retries)

    def body(c):
        lam_, dlam_, ks_, Ks_, dV_, ok_, failed_, n_ = c
        retry = ~ok_ & ~failed_
        dlam_n = jnp.maximum(dlam_ * config.lambda_factor, config.lambda_factor)
        lam_n = jnp.maximum(lam_ * dlam_n, config.lambda_min)
        dlam_ = jnp.where(retry, dlam_n, dlam_)
        lam_ = jnp.where(retry, lam_n, lam_)
        failed_ = failed_ | (retry & (lam_ > config.lambda_max))
        ks2, Ks2, dV2, ok2 = backward_fn(lam_)
        take = retry & ~failed_ & ok2
        ks_ = jnp.where(take[None, None, :], ks2, ks_)
        Ks_ = jnp.where(take[None, None, None, :], Ks2, Ks_)
        dV_ = jnp.where(take[None, :], dV2, dV_)
        return (lam_, dlam_, ks_, Ks_, dV_, ok_ | take, failed_, n_ + 1)

    lam, dlam, ks, Ks, dV, ok_all, failed, _ = lax.while_loop(
        cond, body,
        (lam, dlam, ks, Ks, dV, ok_all, jnp.zeros((B,), bool), jnp.int32(0)))
    return lam, dlam, ks, Ks, dV, failed


class _StackedState(NamedTuple):
    it: jnp.ndarray
    iters: jnp.ndarray    # [B] per-lane iteration count
    status: jnp.ndarray   # [B]
    xs: jnp.ndarray       # [N+1, nx, S, L] lane-blocked
    us: jnp.ndarray       # [N, nu, S, L]
    costs: jnp.ndarray    # [N+1, S, L]
    ks: jnp.ndarray       # [N, nu, S, L]
    Ks: jnp.ndarray       # [N, nu, nx, S, L]
    lam: jnp.ndarray      # [B]
    dlam: jnp.ndarray     # [B]
    ls_consec: jnp.ndarray  # scalar int32: consecutive all-accept-alpha[0]
    #                         iterations (the adaptive ls predictor's state)
    trace: DDPTrace       # arrays [B, max_iter+1]


def _solve_stacked(problem: Problem, config: DDPConfig, t0, x0s, us_init) -> DDPResult:
    """Natively-batched DDP solve.  Public layout is batch-first; internally
    EVERYTHING is lane-blocked [..., S, L] end-to-end — rollout, derivative
    sweep, backward kernel (trailing lanes merged to a flat batch axis for
    kernels/ddp_backward.py, a free reshape), and both forward passes — so
    no layout transpose occurs anywhere inside the iteration loop.
    Per-lane control flow reproduces ``_solve``-under-vmap exactly (tested).
    """
    from nmpc_tpu.kernels.ddp_backward import (
        StackedBounds, StackedDerivs, StackedSecond)
    from nmpc_tpu.kernels.lanes import block_lanes, lane_factors, unblock_lanes

    dtype = x0s.dtype
    t0 = jnp.asarray(t0, dtype)
    B = x0s.shape[0]
    N = config.horizon_steps
    nx, nu = problem.state_dim, problem.input_dim
    assert us_init.shape == (B, N, nu), (
        f"initial_u_list must have shape {(B, N, nu)}, got {us_init.shape}"
    )
    n_trace = config.max_iter + 1
    alphas = jnp.asarray(config.alpha_list, dtype)
    A = len(config.alpha_list)
    S, L = lane_factors(B)

    # trailing (S, L) <-> flat B: contiguous merges, free at the XLA level
    flat = lambda a: a.reshape(a.shape[:-2] + (B,))
    lanes = lambda a: a.reshape(a.shape[:-1] + (S, L))

    d_sweep = functools.partial(_derivative_sweep_lanes, problem, config)
    f_costs = functools.partial(_forward_costs_lanes, problem, config)
    f_sel = functools.partial(_forward_selected_lanes, problem, config)

    boxed = config.with_input_constraint
    second = config.use_state_eq_second_derivative
    impl = _resolve_backward_impl(config, problem, dtype, boxed, second)

    xs, costs = _rollout_lanes(problem, config, t0,
                               block_lanes(x0s, 0, S, L),
                               block_lanes(us_init, 0, S, L))

    cdtype = _ls_cost_dtype(problem, config,
                            t0 + problem.dt * jnp.arange(N, dtype=dtype),
                            xs, block_lanes(us_init, 0, S, L))
    fwd_fused = _resolve_forward_fused(config, problem, dtype, cdtype)

    if fwd_fused:
        from nmpc_tpu.kernels.ddp_forward_remat import forward_selected_remat

        def f_sel(t0_, xs_l, us_l, ks_l, Ks_l, alpha_l):
            xsn, usn, cs, csum = forward_selected_remat(
                problem, config, t0_, flat(xs_l), flat(us_l), flat(ks_l),
                flat(Ks_l), flat(alpha_l))
            return lanes(xsn), lanes(usn), lanes(cs), lanes(csum)

    def zeros(shape=()):
        return jnp.zeros(shape, dtype)

    trace = DDPTrace(
        iter=jnp.broadcast_to(jnp.arange(n_trace, dtype=jnp.int32),
                              (B, n_trace)),
        cost=zeros((B, n_trace)).at[:, 0].set(flat(jnp.sum(costs, axis=0))),
        lam=zeros((B, n_trace)).at[:, 0].set(config.initial_lambda),
        dlam=zeros((B, n_trace)).at[:, 0].set(config.initial_dlambda),
        alpha=zeros((B, n_trace)),
        k_rel_norm=zeros((B, n_trace)),
        cost_update_actual=zeros((B, n_trace)),
        cost_update_expected=zeros((B, n_trace)),
        cost_update_ratio=zeros((B, n_trace)),
    )

    state = _StackedState(
        it=jnp.int32(0),
        iters=jnp.zeros((B,), jnp.int32),
        status=jnp.full((B,), DDPStatus.RUNNING, jnp.int32),
        xs=xs, us=block_lanes(us_init, 0, S, L), costs=costs,
        ks=zeros((N, nu, S, L)), Ks=zeros((N, nu, nx, S, L)),
        lam=jnp.full((B,), config.initial_lambda, dtype),
        dlam=jnp.full((B,), config.initial_dlambda, dtype),
        # optimistic init (counts as a full accept history): iteration 1
        # tries the 1-scan head path
        ls_consec=jnp.int32(max(1, config.ls_auto_hysteresis)),
        trace=trace,
    )

    def cond(s: _StackedState):
        return jnp.any(s.status == DDPStatus.RUNNING)

    def body(s: _StackedState):
        it = s.it + 1
        running = s.status == DDPStatus.RUNNING          # [B]
        run_sl = lanes(running)                          # [S, L]

        # Step 1+2: derivative sweep + backward kernel.  On the "remat"
        # impl the sweep is ELIMINATED — only the terminal expansion is
        # computed here; stage derivatives are recomputed from (x_i, u_i)
        # inside the fused kernel (kernels/ddp_backward_remat.py), so the
        # ~75 MB/iteration stage-derivative buffer never exists.
        if impl == "remat":
            from nmpc_tpu.kernels.ddp_backward_remat import backward_remat

            VxT, VxxT = _terminal_quad_lanes(problem, config, t0, s.xs)
            xs_f, us_f = flat(s.xs), flat(s.us)

            def backward_fn(lam_):
                return backward_remat(problem, config, t0, xs_f, us_f,
                                      flat(VxT), flat(VxxT), lam_,
                                      boxed=boxed)
        else:
            D, VxT, VxxT = d_sweep(t0, s.xs, s.us)
            Dst = StackedDerivs(Fx=flat(D.Fx), Fu=flat(D.Fu), Lx=flat(D.Lx),
                                Lu=flat(D.Lu), Lxx=flat(D.Lxx),
                                Luu=flat(D.Luu), Lxu=flat(D.Lxu))
            bounds = None
            if boxed:
                bounds = StackedBounds(lower=flat(D.lower),
                                       upper=flat(D.upper), u=flat(D.u))
            D2 = None
            if second:
                D2 = StackedSecond(Fxx=flat(D.Fxx), Fuu=flat(D.Fuu),
                                   Fxu=flat(D.Fxu))
            backward_fn = _make_backward_fn(config, impl, Dst, flat(VxT),
                                            flat(VxxT), bounds=bounds, D2=D2)

        # per-lane lambda retry around the bound kernel (flat-B batch-minor)
        lam, dlam, ks_f, Ks_f, dV, bw_failed = _backward_retry(
            config, backward_fn, s.lam, s.dlam,
            flat(s.ks), flat(s.Ks), running)
        ks = lanes(ks_f)                     # [N, nu, S, L]
        Ks = lanes(Ks_f)                     # [N, nu, nx, S, L]

        status = jnp.where(bw_failed & running,
                           jnp.int32(DDPStatus.FAIL_BACKWARD_LAMBDA),
                           s.status)

        # small-gradient termination
        k_rel_norm = jnp.max(
            jnp.sqrt(jnp.sum(ks_f**2, axis=1))
            / (jnp.sqrt(jnp.sum(flat(s.us)**2, axis=1)) + 1.0), axis=0)  # [B]
        term_grad = (running & ~bw_failed
                     & (k_rel_norm < config.k_rel_norm_thre)
                     & (lam < config.lambda_thre))
        status = jnp.where(term_grad, jnp.int32(DDPStatus.SUCCEEDED), status)

        # Step 3: forward line search (identical accept decisions in
        # every mode — the reference's serial first-accept loop,
        # DDPSolver.hpp:242-265).  Default "auto" = per-iteration
        # lax.cond between head_path and sweep_path driven by an
        # accept-history hysteresis predictor.  See DDPConfig.ls_mode for
        # the mode inventory.
        cost_old = flat(jnp.sum(s.costs, axis=0))                  # [B]
        expected = -alphas[:, None] * (dV[0][None, :]
                                       + alphas[:, None] * dV[1][None, :])
        do_forward = running & ~bw_failed & ~term_grad
        # common dtype for the cond branches' scalar outputs (the tail's
        # cost sums may be wider under deriv_dtype="float64")
        wdtype = jnp.promote_types(dtype, _deriv_dtype_of(config, dtype))

        def ratio_of(actual_a, expected_a):
            return jnp.where(expected_a < 0,
                             jnp.where(actual_a >= 0, 1.0, -1.0),
                             actual_a / expected_a)

        def pick_alpha(cand_sums):
            """First-accept alpha selection from per-alpha cost sums
            [A, B] (identical decision to the reference's serial loop)."""
            actual = cost_old[None, :] - cand_sums                 # [A, B]
            ratio = ratio_of(actual, expected)
            accept_mask = ratio > config.cost_update_ratio_thre
            fw_success = jnp.any(accept_mask, axis=0)              # [B]
            first_idx = jnp.argmax(accept_mask, axis=0)
            idx = jnp.where(fw_success, first_idx, A - 1).astype(jnp.int32)
            sel = lambda a: jnp.take_along_axis(a, idx[None, :], axis=0)[0]
            all_a0 = ~jnp.any(do_forward & ~accept_mask[0])
            return (idx, fw_success, sel(actual).astype(wdtype),
                    sel(expected), sel(ratio).astype(wdtype), all_a0)

        def head_path(_):
            h_xs, h_us, h_costs, h_sum = f_sel(
                t0, s.xs, s.us, ks, Ks, jnp.full(s.xs.shape[-2:], alphas[0]))
            # h_sum is accumulated inside f_sel's scan exactly like the
            # sweep path's per-alpha sums (same order, same cdtype), so the
            # alpha[0] accept decision is bit-identical across ls modes at
            # any precision
            sum0 = flat(h_sum)                                     # [B]
            actual0 = (cost_old - sum0).astype(wdtype)
            ratio0 = ratio_of(actual0, expected[0].astype(wdtype))
            accept0 = ratio0 > config.cost_update_ratio_thre       # [B]
            all_a0 = ~jnp.any(do_forward & ~accept0)

            def with_tail(_):
                rest = flat(f_costs(t0, s.xs, s.us, ks, Ks,
                                    alphas_override=config.alpha_list[1:]))
                cand_sums = jnp.concatenate(
                    [sum0[None].astype(rest.dtype), rest], axis=0)
                out = pick_alpha(cand_sums)
                sel_xs, sel_us, sel_costs, _ = f_sel(
                    t0, s.xs, s.us, ks, Ks, lanes(alphas[out[0]]))
                return (sel_xs, sel_us, sel_costs) + out

            def head_only(_):
                idx = jnp.zeros((B,), jnp.int32)
                return (h_xs, h_us, h_costs, idx, accept0, actual0,
                        expected[0], ratio0.astype(wdtype), all_a0)

            return lax.cond(~all_a0, with_tail, head_only, operand=None)

        def sweep_path(_):
            cand_sums = flat(f_costs(t0, s.xs, s.us, ks, Ks))      # [A, B]
            out = pick_alpha(cand_sums)
            sel_xs, sel_us, sel_costs, _ = f_sel(
                t0, s.xs, s.us, ks, Ks, lanes(alphas[out[0]]))
            return (sel_xs, sel_us, sel_costs) + out

        def serial_path(_):
            """The reference's serial early-exit alpha loop
            (DDPSolver.hpp:242-265), batched: a while_loop walks the
            schedule; each trip rolls ONE alpha out fully (trajectory
            included) and still-searching lanes where-select it on their
            first accept.  Accept decisions are bit-identical to the
            other modes (the per-trip cost sum comes from f_sel's in-scan
            cdtype accumulator — the same values the sweep compares).

            The while_loop's per-trip where-updates copy the full candidate
            trajectory buffers, and deep backtracking pays
            max-first-accept-depth full rollouts; the mode stays because
            it is the only search whose cost model matches the reference's
            serial loop exactly (apples-to-apples comparisons).
            """
            ex_w = expected.astype(wdtype)                         # [A, B]

            def cond_fn(st):
                k = st[0]
                accepted = st[2]
                return (k < A) & jnp.any(do_forward & ~accepted)

            def body_fn(st):
                (k, idx, accepted, sxs, sus, scosts, act, exp_, rat) = st
                alpha_k = alphas[k]
                c_xs, c_us, c_costs, c_sum = f_sel(
                    t0, s.xs, s.us, ks, Ks,
                    jnp.full(s.xs.shape[-2:], alpha_k))
                actual_k = (cost_old - flat(c_sum)).astype(wdtype)
                ratio_k = ratio_of(actual_k, ex_w[k])
                acc_k = ratio_k > config.cost_update_ratio_thre    # [B]
                rec = do_forward & ~accepted     # still-searching lanes
                rec_sl = lanes(rec)
                sxs = jnp.where(rec_sl, c_xs, sxs)
                sus = jnp.where(rec_sl, c_us, sus)
                scosts = jnp.where(rec_sl, c_costs, scosts)
                act = jnp.where(rec, actual_k, act)
                exp_ = jnp.where(rec, expected[k], exp_)
                rat = jnp.where(rec, ratio_k, rat)
                idx = jnp.where(rec, k, idx)
                return (k + 1, idx, accepted | (rec & acc_k), sxs, sus,
                        scosts, act, exp_, rat)

            z = jnp.zeros((B,), wdtype)
            st0 = (jnp.int32(0), jnp.full((B,), A - 1, jnp.int32),
                   jnp.zeros((B,), bool), s.xs, s.us, s.costs,
                   z, jnp.zeros((B,), dtype), z)
            (_, idx, accepted, sxs, sus, scosts, act, exp_, rat) = (
                lax.while_loop(cond_fn, body_fn, st0))
            fw_success = accepted
            all_a0 = ~jnp.any(do_forward & ~(accepted & (idx == 0)))
            return (sxs, sus, scosts, idx, fw_success, act, exp_, rat,
                    all_a0)

        if A <= 1:
            ls_out = head_path(None)
        elif config.ls_mode == "head":
            ls_out = head_path(None)
        elif config.ls_mode == "sweep":
            ls_out = sweep_path(None)
        elif config.ls_mode == "serial":
            ls_out = serial_path(None)
        else:  # adaptive: accept-history hysteresis carried across iters
            h = max(1, config.ls_auto_hysteresis)
            ls_out = lax.cond(s.ls_consec >= h, head_path, sweep_path,
                              operand=None)
        (sel_xs, sel_us, sel_costs, idx, fw_success, actual_sel,
         expected_sel, ratio_sel, all_accept0) = ls_out

        accept = do_forward & fw_success
        acc_sl = lanes(accept)                                     # [S, L]

        xs = jnp.where(acc_sl, sel_xs, s.xs)
        us = jnp.where(acc_sl, sel_us, s.us)
        costs = jnp.where(acc_sl, sel_costs, s.costs)

        term_cost = accept & (actual_sel < config.cost_update_thre)
        status = jnp.where(term_cost, jnp.int32(DDPStatus.SUCCEEDED), status)

        dlam_acc = jnp.minimum(dlam / config.lambda_factor,
                               1.0 / config.lambda_factor)
        lam_acc = jnp.where(lam >= config.lambda_min, lam * dlam_acc, 0.0)
        dlam_rej = jnp.maximum(dlam * config.lambda_factor, config.lambda_factor)
        lam_rej = jnp.maximum(lam * dlam_rej, config.lambda_min)
        reject = do_forward & ~fw_success
        lam = jnp.where(accept, lam_acc, jnp.where(reject, lam_rej, lam))
        dlam = jnp.where(accept, dlam_acc, jnp.where(reject, dlam_rej, dlam))
        status = jnp.where(reject & (lam > config.lambda_max),
                           jnp.int32(DDPStatus.FAIL_FORWARD_LAMBDA), status)

        # gains kept from the last successful backward
        good_bw = lanes(running & ~bw_failed)
        ks = jnp.where(good_bw, ks, s.ks)
        Ks = jnp.where(good_bw, Ks, s.Ks)

        # trace row `it` for running lanes
        tr = s.trace
        reached_fwd = do_forward

        def trow(col, val, mask):
            # val may be wider than the trace (fp64 cost accumulators under
            # deriv_dtype="float64"); scatter requires matching dtypes
            val = jnp.asarray(val, col.dtype)
            return col.at[:, it].set(jnp.where(mask, val, col[:, it]))

        tr = DDPTrace(
            iter=tr.iter,
            cost=trow(tr.cost, flat(jnp.sum(costs, axis=0)), reached_fwd),
            lam=trow(tr.lam, lam, reached_fwd),
            dlam=trow(tr.dlam, dlam, reached_fwd),
            alpha=trow(tr.alpha, alphas[idx], reached_fwd),
            k_rel_norm=trow(tr.k_rel_norm, k_rel_norm, running & ~bw_failed),
            cost_update_actual=trow(tr.cost_update_actual, actual_sel, reached_fwd),
            cost_update_expected=trow(tr.cost_update_expected, expected_sel, reached_fwd),
            cost_update_ratio=trow(tr.cost_update_ratio, ratio_sel, reached_fwd),
        )

        status = jnp.where((status == DDPStatus.RUNNING) & (it >= config.max_iter),
                           jnp.int32(DDPStatus.MAX_ITER_REACHED), status)

        # freeze non-running lanes wholesale
        fz = lambda n_, o_: jnp.where(run_sl, n_, o_)      # trailing (S, L)
        fzb = lambda n_, o_: jnp.where(running, n_, o_)    # [B]
        return _StackedState(
            it=it,
            iters=jnp.where(running, s.iters + 1, s.iters),
            status=status,  # status transitions only fire from RUNNING
            xs=fz(xs, s.xs), us=fz(us, s.us), costs=fz(costs, s.costs),
            ks=fz(ks, s.ks), Ks=fz(Ks, s.Ks),
            lam=fzb(lam, s.lam), dlam=fzb(dlam, s.dlam),
            ls_consec=jnp.where(
                all_accept0,
                jnp.minimum(s.ls_consec + 1,
                            jnp.int32(max(1, config.ls_auto_hysteresis))),
                jnp.int32(0)),
            trace=jax.tree_util.tree_map(
                lambda n_, o_: jnp.where(running[:, None], n_, o_), tr, s.trace),
        )

    out = lax.while_loop(cond, body, state)

    ub = lambda a: unblock_lanes(a, 0)
    return DDPResult(
        status=out.status,
        success=out.status == DDPStatus.SUCCEEDED,
        iters=out.iters,
        xs=ub(out.xs),
        us=ub(out.us),
        costs=ub(out.costs),
        ks=ub(out.ks),
        Ks=ub(out.Ks),
        lam=out.lam,
        dlam=out.dlam,
        trace=out.trace,
    )
