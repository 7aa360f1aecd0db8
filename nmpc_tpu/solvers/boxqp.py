"""Projected-Newton QP with box constraints, batched (masked, static-shape).

Algorithmic equivalent of the reference ``nmpc_ddp::BoxQP``
(``nmpc_ddp/include/nmpc_ddp/BoxQP.h:126-347``; Tassa, Mansard, Todorov,
"Control-limited differential dynamic programming", ICRA 2014):

  * active-set "clamped" detection with exact bound equality
    (``BoxQP.h:187-206``),
  * Newton step on the free block via Cholesky (``BoxQP.h:216-279``),
  * Armijo backtracking with clamp projection (``BoxQP.h:293-309``),
  * the same return-code table (``BoxQP.h:375-383``).

Batched redesign notes
----------------------
The reference gathers the free sub-matrix ``H_free`` and refactorizes only
when the clamped set changes.  Gathers and dynamic shapes defeat XLA, so we
instead solve the *masked* fixed-shape system

    (F H F + C) y = rhs,     F = diag(free), C = diag(clamped)

whose free block is exactly ``H_free`` and whose clamped block is identity —
the Newton step and the feedback-gain solve read off the free rows directly,
with zero rows for clamped dims.  The loop is a ``lax.while_loop`` (early
exit preserved; under ``vmap`` lanes are masked independently), every
iteration refactorizes (a [nu,nu] Cholesky is a handful of elementwise ops at the
sizes MPC sees, cheaper than branching).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from nmpc_tpu.core.types import BoxQPConfig, BoxQPStatus
from nmpc_tpu.kernels.linalg import cho_solve_small, cholesky_small


class BoxQPResult(NamedTuple):
    x: jnp.ndarray          # solution [n]
    status: jnp.ndarray     # int32, BoxQPStatus (negative = failure)
    free_mask: jnp.ndarray  # bool [n] — free set of the last factorization
    chol: jnp.ndarray       # [n, n] lower Cholesky of (F H F + C)
    iters: jnp.ndarray      # int32
    obj: jnp.ndarray        # final objective value


def _objective(x, H, g):
    return x @ g + 0.5 * x @ (H @ x)


def boxqp_solve(H, g, lower, upper, x0, config: BoxQPConfig = BoxQPConfig()) -> BoxQPResult:
    """Minimize 0.5 x'Hx + g'x  s.t. lower <= x <= upper.

    Matches ``BoxQP::solve`` (``BoxQP.h:141-347``) step for step; see module
    docstring for the masked reformulation.
    """
    n = g.shape[0]
    dtype = g.dtype
    eye = jnp.eye(n, dtype=dtype)

    x = jnp.clip(x0, lower, upper)
    obj = _objective(x, H, g)

    class Carry(NamedTuple):
        x: jnp.ndarray
        obj: jnp.ndarray
        old_obj: jnp.ndarray
        status: jnp.ndarray
        it: jnp.ndarray
        free_mask: jnp.ndarray
        chol: jnp.ndarray

    init = Carry(
        x=x,
        obj=obj,
        old_obj=obj,
        status=jnp.int32(BoxQPStatus.NOT_FINISHED),
        it=jnp.int32(0),
        free_mask=jnp.ones((n,), dtype=bool),
        chol=eye,
    )

    def cond(c: Carry):
        return c.status == BoxQPStatus.NOT_FINISHED

    def body(c: Carry):
        it = c.it + 1

        # Relative-improvement termination (BoxQP.h:176-181); checked before
        # anything else, so free set / factorization keep previous values.
        improve_done = (it > 1) & (
            (c.old_obj - c.obj) < config.rel_improve_thre * jnp.abs(c.old_obj)
        )

        old_obj = c.obj
        grad = g + H @ c.x

        # Clamped set: at a bound with the gradient pushing outward
        # (BoxQP.h:187-191). Exact equality is intentional — x was projected.
        clamped = ((c.x == lower) & (grad > 0)) | ((c.x == upper) & (grad < 0))
        free = ~clamped
        all_clamped = jnp.all(clamped)

        fm = free.astype(dtype)
        cm = clamped.astype(dtype)

        # Masked free-block system (see module docstring).
        H_masked = (fm[:, None] * H * fm[None, :]) + jnp.diag(cm)
        chol_safe, chol_ok = cholesky_small(H_masked)

        grad_norm2 = jnp.sum(fm * grad * grad)
        small_grad = grad_norm2 < config.grad_thre**2

        # Newton direction on the free subspace (BoxQP.h:256-279):
        # d_free = -H_ff^{-1} (g_f + H_fc x_c) - x_f, zero on clamped dims.
        rhs = fm * (g + H @ (cm * c.x))
        d = fm * (-cho_solve_small(chol_safe, rhs) - fm * c.x)
        sdg = d @ grad
        bad_dir = sdg > 1e-10  # "should not happen" guard (BoxQP.h:283-291)

        # Armijo backtracking with projection (BoxQP.h:293-309).
        def ls_candidate(step):
            xc = jnp.clip(c.x + step * d, lower, upper)
            return xc, _objective(xc, H, g)

        step0 = jnp.asarray(1.0, dtype)
        xc0, objc0 = ls_candidate(step0)

        def ls_cond(s):
            step, _, objc, hit_min, k = s
            armijo_fail = (objc - old_obj) / (step * sdg) < config.armijo_param
            return armijo_fail & (~hit_min) & (k < config.max_ls_iter)

        def ls_body(s):
            step, _, _, _, k = s
            step = step * config.step_factor
            xc, objc = ls_candidate(step)
            return (step, xc, objc, step < config.min_step, k + 1)

        step_f, x_cand, obj_cand, hit_min, _ = lax.while_loop(
            ls_cond, ls_body, (step0, xc0, objc0, jnp.bool_(False), jnp.int32(0))
        )
        # exhaustion = min_step reached (BoxQP.h:304-308) or, for truncated
        # max_ls_iter schedules, the schedule ran out with the final
        # candidate still failing Armijo; either way the LAST-visited
        # candidate (x_cand) is the accepted result — the reference's rule.
        ls_exhausted = hit_min | (
            (obj_cand - old_obj) / (step_f * sdg) < config.armijo_param)

        # Resolve this iteration's terminal status, in the reference's check
        # order: improvement(4) -> all-clamped(6) -> chol failure(-1)
        # -> small gradient(5) -> bad direction(-2) -> ls-exhausted(2)
        # -> max-iter(1).  Note on MAX_LS_ITER: the reference assigns
        # retval_ = 2 when step < min_step (BoxQP.h:304-308) but its main
        # loop then continues and every later exit overwrites retval_, so 2
        # is never observable as a final value there; here exhaustion
        # terminates with the accepted tiny-step candidate (the Tassa-2014
        # semantic), making the retcode observable.  Deviation documented
        # in ARCHITECTURE.md.
        status = jnp.int32(BoxQPStatus.NOT_FINISHED)

        def pick(cond_, code, status):
            return jnp.where(
                (status == BoxQPStatus.NOT_FINISHED) & cond_, jnp.int32(code), status
            )

        status = pick(improve_done, BoxQPStatus.SMALL_IMPROVEMENT, status)
        status = pick(all_clamped, BoxQPStatus.ALL_CLAMPED, status)
        status = pick(~chol_ok, BoxQPStatus.HESSIAN_NOT_PD, status)
        status = pick(small_grad, BoxQPStatus.SMALL_GRADIENT, status)
        status = pick(bad_dir, BoxQPStatus.POSITIVE_DIR_DERIV, status)
        status = pick(ls_exhausted, BoxQPStatus.MAX_LS_ITER, status)
        status = pick(it >= config.max_iter, BoxQPStatus.MAX_ITER, status)

        # Whether x/obj advance this iteration (they do unless we broke before
        # the line search; MAX_ITER still accepts the candidate, BoxQP.h:327-336).
        pre_ls_exit = improve_done | all_clamped | (~chol_ok) | small_grad | bad_dir
        x_new = jnp.where(pre_ls_exit, c.x, x_cand)
        obj_new = jnp.where(pre_ls_exit, c.obj, obj_cand)

        # free set / factorization exposed to the caller: last *computed*
        # values (improvement exit keeps the previous iteration's).
        keep_prev_factor = improve_done
        free_out = jnp.where(keep_prev_factor, c.free_mask, free)
        chol_out = jnp.where(keep_prev_factor, c.chol, chol_safe)

        return Carry(
            x=x_new,
            obj=obj_new,
            old_obj=old_obj,
            status=status,
            it=it,
            free_mask=free_out,
            chol=chol_out,
        )

    out = lax.while_loop(cond, body, init)
    return BoxQPResult(
        x=out.x,
        status=out.status,
        free_mask=out.free_mask,
        chol=out.chol,
        iters=out.it,
        obj=out.obj,
    )
