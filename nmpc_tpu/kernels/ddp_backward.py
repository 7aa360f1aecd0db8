"""Batch-minor ("stacked") DDP backward pass — the hot kernel.

Why this exists: under plain ``vmap`` the backward scan's stage matrices are
``[B, nx, nx]``, so the tiny matrix dims are the minor (fastest) axes and
every intermediate is a padded, strided tile of a few useful elements.

Batch-minor layout: put the batch on the minor axis.  Every stage quantity
is stored ``[..., small_dims..., B]``, so every intermediate is contiguous
and coalesced over the batch, and the small-matrix contractions unroll into
elementwise ops over the batch.
This is the "single fused, batch-wide kernel" shape SURVEY.md §7 calls the
central engineering risk of the port.

Math is identical to ``solvers/ddp.py::_backward`` (reference
``DDPSolver.hpp:343-534``), minus the boxed-input and second-order paths
(those fall back to the scan implementation).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from nmpc_tpu.core.types import DDPConfig


class StackedDerivs(NamedTuple):
    """Stage derivatives, batch-minor: leading axis N, trailing axis B."""

    Fx: jnp.ndarray   # [N, nx, nx, B]
    Fu: jnp.ndarray   # [N, nx, nu, B]
    Lx: jnp.ndarray   # [N, nx, B]
    Lu: jnp.ndarray   # [N, nu, B]
    Lxx: jnp.ndarray  # [N, nx, nx, B]
    Luu: jnp.ndarray  # [N, nu, nu, B]
    Lxu: jnp.ndarray  # [N, nx, nu, B]


class StackedBounds(NamedTuple):
    """Box-constraint data for the boxed backward (batch-minor)."""

    lower: jnp.ndarray  # [N, nu, B] bounds relative shift base: absolute
    upper: jnp.ndarray  # [N, nu, B]
    u: jnp.ndarray      # [N, nu, B] current inputs (bounds taken relative)


class StackedSecond(NamedTuple):
    """Second-order dynamics tensors for full DDP, batch-minor.

    The reference declares these curvature terms but leaves them
    unimplemented (``DDPSolver.hpp:391-414``); here they ride the same
    batch-minor fast path as the first-order terms."""

    Fxx: jnp.ndarray  # [N, nx, nx, nx, B]
    Fuu: jnp.ndarray  # [N, nx, nu, nu, B]
    Fxu: jnp.ndarray  # [N, nx, nx, nu, B]


def _vx_dot_f2(Vx, F2):
    """Contract Vx [nx, B] with a second-order tensor [nx, a, b, B]
    -> [a, b, B] (the Vx . Fab curvature term)."""
    return jnp.sum(Vx[:, None, None, :] * F2, axis=0)


def _mm(A, B):
    """[i, k, B] @ [k, j, B] -> [i, j, B] (broadcast-multiply + reduce,
    keeps the batch on the lanes; no dot_general)."""
    return jnp.sum(A[:, :, None, :] * B[None, :, :, :], axis=1)


def _mT(A):
    return jnp.swapaxes(A, 0, 1)


def _mv(A, v):
    """[i, k, B] @ [k, B] -> [i, B]."""
    return jnp.sum(A * v[None, :, :], axis=1)


def _chol_bl(A):
    """Cholesky of [n, n, B] SPD, unrolled; returns (L rows list, ok [B])."""
    n = A.shape[0]
    ok = jnp.ones(A.shape[-1], dtype=bool)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        ok = ok & (d > 0) & jnp.isfinite(d)
        Ljj = jnp.sqrt(jnp.where(d > 0, d, 1.0))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L, ok


def _chol_solve_bl(L, B):
    """Solve (L L^T) X = B for [n, m, B] rhs with L from :func:`_chol_bl`."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = B[i]
        for k in range(i):
            s = s - L[i][k][None, :] * y[k]
        y[i] = s / L[i][i][None, :]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][None, :] * x[k]
        x[i] = s / L[i][i][None, :]
    return jnp.stack(x, axis=0)


def _obj_bl(x, H, g):
    return jnp.sum(x * g, axis=0) + 0.5 * jnp.sum(x * _mv(H, x), axis=0)


def boxqp_stacked(H, g, lower, upper, x0, config):
    """Batch-minor projected-Newton BoxQP (reference ``BoxQP.h:141-347``).

    All arrays carry trailing batch B: H [n,n,B], rest [n,B].  Per-lane
    control flow (early exits, Armijo backtracking) is masked, exactly
    matching ``solvers/boxqp.py`` under vmap.  Returns
    (x, ok [B], free_mask [n,B], cholL [n,n,B], iters).
    """
    from nmpc_tpu.core.types import BoxQPStatus

    n, B = g.shape
    dtype = g.dtype
    eye = jnp.eye(n, dtype=dtype)[:, :, None]

    x = jnp.clip(x0, lower, upper)
    obj = _obj_bl(x, H, g)

    class C(NamedTuple):
        x: jnp.ndarray
        obj: jnp.ndarray
        old_obj: jnp.ndarray
        status: jnp.ndarray   # [B]
        it: jnp.ndarray
        free: jnp.ndarray     # [n, B] float
        chol: jnp.ndarray     # [n, n, B]

    init = C(x=x, obj=obj, old_obj=obj,
             status=jnp.zeros((B,), jnp.int32), it=jnp.int32(0),
             free=jnp.ones((n, B), dtype), chol=jnp.broadcast_to(eye, (n, n, B)) * 1.0)

    def cond(c: C):
        return jnp.any(c.status == 0) & (c.it < config.max_iter)

    def body(c: C):
        active = c.status == 0
        # freeze the counter once every lane is done so the unrolled phase
        # does not inflate the trip-count diagnostics
        it = jnp.where(jnp.any(active), c.it + 1, c.it)

        improve_done = (it > 1) & (
            (c.old_obj - c.obj) < config.rel_improve_thre * jnp.abs(c.old_obj))
        old_obj = jnp.where(active, c.obj, c.old_obj)

        grad = g + _mv(H, c.x)
        clamped = (((c.x == lower) & (grad > 0))
                   | ((c.x == upper) & (grad < 0)))
        free = (~clamped).astype(dtype)
        cm = clamped.astype(dtype)
        all_clamped = jnp.all(clamped, axis=0)

        H_masked = free[:, None, :] * H * free[None, :, :] + eye * cm[None, :, :]
        Lrows, chol_ok = _chol_bl(H_masked)
        cholL = jnp.stack([jnp.stack(
            [Lrows[i][j] if j <= i else jnp.zeros((B,), dtype)
             for j in range(n)], axis=0) for i in range(n)], axis=0)

        grad_norm2 = jnp.sum(free * grad * grad, axis=0)
        small_grad = grad_norm2 < config.grad_thre**2

        rhs = free * (g + _mv(H, cm * c.x))
        d = free * (-_chol_solve_bl(Lrows, rhs[:, None, :])[:, 0, :]
                    - free * c.x)
        sdg = jnp.sum(d * grad, axis=0)
        bad_dir = sdg > 1e-10

        pre_exit = improve_done | all_clamped | (~chol_ok) | small_grad | bad_dir

        # Armijo backtracking (BoxQP.h:293-309), two-phase: a
        # PARALLEL head over the first ls_block steps — in practice every
        # accept lands there (evaluating all 105 candidates would stream
        # [K,n,n,B] broadcasts per QP iteration) — then a masked
        # sequential while_loop tail for the rare lane that backtracks
        # deeper, preserving exact first-accept/exhaustion semantics over
        # the full schedule.  The candidates are the same clip(x + 0.6^j d)
        # values the reference's sequential loop would visit.
        n_ls = config.max_ls_iter + 1
        K1 = min(config.ls_block, n_ls)
        # cumprod, not pow: the sequential loop forms 0.6^j by repeated
        # multiplication, so cumprod reproduces its step values bit-for-bit
        steps_h = jnp.concatenate([
            jnp.ones((1,), dtype),
            jnp.cumprod(jnp.full((K1 - 1,), config.step_factor, dtype)),
        ])                                                   # [K1] 1, 0.6, ..
        xc = jnp.clip(c.x[None] + steps_h[:, None, None] * d[None],
                      lower[None], upper[None])              # [K1, n, B]
        # broadcast-multiply-reduce, same lane layout as _mv (einsum's
        # dot_general relayouts [K, n, B] per trip and is ~10x slower here)
        Hxc = jnp.sum(H[None] * xc[:, None, :, :], axis=2)   # [K1, n, B]
        objc = (jnp.sum(xc * g[None], axis=1)
                + 0.5 * jnp.sum(xc * Hxc, axis=1))           # [K1, B]
        ratio = (objc - old_obj[None]) / (steps_h[:, None] * sdg[None])
        accept = ratio >= config.armijo_param                # [K1, B]
        below = (steps_h < config.min_step)[:, None]         # [K1, 1]
        stop = accept | below                                # [K1, B]
        any_stop = jnp.any(stop, axis=0)                     # [B]
        # first stopping index per lane; select via one-hot reduction —
        # take_along_axis lowers to a gather, where a K-sized masked
        # reduce stays elementwise.  A lane with no stop takes the
        # LAST-visited candidate (K1-1): if the head covers the whole
        # schedule that is the reference's exhaustion result (the last —
        # tiniest — candidate is accepted, BoxQP.h:298-309); otherwise the
        # tail overwrites it on its first trip.
        k_star = jnp.where(any_stop, jnp.argmax(stop, axis=0),
                           jnp.int32(K1 - 1))                # [B]
        onehot = (jnp.arange(K1)[:, None] == k_star[None, :]).astype(dtype)
        x_cand = jnp.sum(xc * onehot[:, None, :], axis=0)
        obj_cand = jnp.sum(objc * onehot, axis=0)
        # a below-min_step stop is exhaustion REGARDLESS of its Armijo
        # result: the reference breaks with retval 2 at step < min_step
        # without consulting Armijo (BoxQP.h:304-308), and boxqp_solve's
        # hit_min flag matches — so must this kernel
        ls_exhausted = jnp.sum(below * onehot, axis=0) > 0.5
        if K1 == n_ls:
            # head covered the whole schedule: no-stop lanes exhausted it
            ls_exhausted = ls_exhausted | ~any_stop

        # sequential tail (steps K1..max_ls_iter) for lanes with no accept
        # in the head; zero trips in the common case
        need_tail = active & ~pre_exit & ~any_stop
        if K1 < n_ls:
            def ls_cond(s):
                step, xt, objt, exh, k, done = s
                return jnp.any(~done) & (k < n_ls)

            def ls_body(s):
                step, xt, objt, exh, k, done = s
                step = jnp.where(done, step, step * config.step_factor)
                xc1 = jnp.clip(c.x + step[None] * d, lower, upper)
                obj1 = _obj_bl(xc1, H, g)
                acc1 = (obj1 - old_obj) / (step * sdg) >= config.armijo_param
                bel1 = step < config.min_step
                # every undone lane tracks its LAST-visited candidate: its
                # stop candidate when it stops here, the schedule's final
                # candidate when it exhausts without a stop — the
                # reference's exhaustion rule (BoxQP.h:298-309 accepts the
                # last — tiniest — candidate)
                upd = ~done
                xt = jnp.where(upd[None], xc1, xt)
                objt = jnp.where(upd, obj1, objt)
                stop1 = (acc1 | bel1) & ~done
                # below-min_step stop = exhaustion regardless of Armijo
                # (BoxQP.h:304-308)
                exh = exh | (stop1 & bel1)
                return (step, xt, objt, exh, k + 1, done | stop1)

            s0 = (jnp.full((B,), steps_h[-1], dtype), x_cand, obj_cand,
                  jnp.zeros((B,), bool), jnp.int32(K1), ~need_tail)
            _, x_cand, obj_cand, exh_t, _, done_t = lax.while_loop(
                ls_cond, ls_body, s0)
            # a lane still not done when k hits n_ls exhausted the schedule
            # and holds its last-visited candidate in x_cand (with the
            # default config steps shrink past min_step first, so this only
            # triggers for truncated max_ls_iter schedules)
            ls_exhausted = ls_exhausted | exh_t | (need_tail & ~done_t)

        status = c.status

        def pick(cond_, code):
            nonlocal status
            status = jnp.where(active & (status == 0) & cond_,
                               jnp.int32(code), status)

        pick(improve_done, BoxQPStatus.SMALL_IMPROVEMENT)
        pick(all_clamped, BoxQPStatus.ALL_CLAMPED)
        pick(~chol_ok, BoxQPStatus.HESSIAN_NOT_PD)
        pick(small_grad, BoxQPStatus.SMALL_GRADIENT)
        pick(bad_dir, BoxQPStatus.POSITIVE_DIR_DERIV)
        # line-search exhaustion terminates with the tiny-step candidate
        # accepted (BoxQP.h:304-308; see solvers/boxqp.py for the
        # observability note on the reference's transient retval_ = 2)
        pick(ls_exhausted, BoxQPStatus.MAX_LS_ITER)
        pick(it >= config.max_iter, BoxQPStatus.MAX_ITER)

        take = active & ~pre_exit
        x_new = jnp.where(take[None, :], x_cand, c.x)
        obj_new = jnp.where(take, obj_cand, c.obj)

        keep_prev = ~active | improve_done
        free_out = jnp.where(keep_prev[None, :], c.free, free)
        chol_out = jnp.where(keep_prev[None, None, :], c.chol, cholL)

        return C(x=x_new, obj=obj_new, old_obj=old_obj, status=status,
                 it=it, free=free_out, chol=chol_out)

    # fixed unrolled phase (fuses into the caller's scan; no while-loop
    # dispatch per trip), then an exact while_loop continuation for lanes
    # that need more iterations — semantics identical to a pure while_loop
    c = init
    for _ in range(min(config.unroll_iter, config.max_iter)):
        c = body(c)
    if config.unroll_iter >= config.max_iter:
        out = c                      # unrolled phase already covers the cap
    else:
        out = lax.while_loop(cond, body, c)
    ok = out.status >= 0
    return out.x, ok, out.free, out.chol, out.it


def backward_stacked_boxed(config: DDPConfig, D: StackedDerivs,
                           bounds: StackedBounds, Vx_T, Vxx_T, lam,
                           D2: StackedSecond | None = None,
                           with_qp_iters: bool = False):
    """Boxed backward pass, batch-minor: BoxQP feedforward + free-subspace
    feedback gains (``DDPSolver.hpp:450-497``), warm-started from the next
    stage's feedforward.  D2 adds the full-DDP curvature terms.
    ``with_qp_iters=True`` additionally returns the per-stage BoxQP
    iteration counts (profiling; benchmarks/profile_boxed_ddp.py)."""
    nx = D.Fx.shape[1]
    nu = D.Fu.shape[2]
    B = Vx_T.shape[-1]
    dtype = Vx_T.dtype
    eye_nx = jnp.eye(nx, dtype=dtype)[:, :, None]

    reg1 = config.reg_type == 1
    reg2 = config.reg_type == 2
    second = D2 is not None

    def bstep(carry, d):
        Vx, Vxx, dV, ok, k_next = carry
        if second:
            (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu), (lo, hi, u_i), (Fxx, Fuu, Fxu) = d
        else:
            (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu), (lo, hi, u_i) = d

        FuT = _mT(Fu)
        FxT = _mT(Fx)
        Qu = Lu + _mv(FuT, Vx)
        Qx = Lx + _mv(FxT, Vx)
        FuT_Vxx = _mm(FuT, Vxx)
        Qux = _mT(Lxu) + _mm(FuT_Vxx, Fx)
        Quu = Luu + _mm(FuT_Vxx, Fu)
        Qxx = Lxx + _mm(FxT_Vxx := _mm(FxT, Vxx), Fx)
        if second:
            VxFxu = _vx_dot_f2(Vx, Fxu)
            VxFuu = _vx_dot_f2(Vx, Fuu)
            VxFxx = _vx_dot_f2(Vx, Fxx)
            Qux = Qux + _mT(VxFxu)
            Quu = Quu + VxFuu
            Qxx = Qxx + VxFxx

        if reg2:
            Vxx_reg = Vxx + lam[None, None, :] * eye_nx
            FuT_Vr = _mm(FuT, Vxx_reg)
            Qux_reg = _mT(Lxu) + _mm(FuT_Vr, Fx)
            Quu_F = Luu + _mm(FuT_Vr, Fu)
            if second:
                Qux_reg = Qux_reg + _mT(VxFxu)
                Quu_F = Quu_F + VxFuu
        else:
            Qux_reg = Qux
            Quu_F = Quu
        if reg1:
            Quu_F = Quu_F + lam[None, None, :] * jnp.eye(nu, dtype=dtype)[:, :, None]

        k, ok_i, free, cholL, qp_it = boxqp_stacked(
            Quu_F, Qu, lo - u_i, hi - u_i, k_next, config.boxqp)
        Lrows = [[cholL[i, j] for j in range(nu)] for i in range(nu)]
        K = -free[:, None, :] * _chol_solve_bl(Lrows, free[:, None, :] * Qux_reg)

        Quu_k = _mv(Quu, k)
        KT = _mT(K)
        dV = dV + jnp.stack([
            jnp.sum(k * Qu, axis=0),
            0.5 * jnp.sum(k * Quu_k, axis=0),
        ])
        Vx_new = Qx + _mv(KT, Quu_k) + _mv(KT, Qu) + _mv(_mT(Qux), k)
        Vxx_new = (Qxx + _mm(KT, _mm(Quu, K)) + _mm(KT, Qux)
                   + _mm(_mT(Qux), K))
        Vxx_new = 0.5 * (Vxx_new + _mT(Vxx_new))

        outs = ((k, K, qp_it) if with_qp_iters else (k, K))
        return (Vx_new, Vxx_new, dV, ok & ok_i, k), outs

    init = (Vx_T, Vxx_T, jnp.zeros((2, B), dtype), jnp.ones((B,), dtype=bool),
            jnp.zeros((nu, B), dtype))
    xs = ((tuple(D), tuple(bounds), tuple(D2)) if second
          else (tuple(D), tuple(bounds)))
    if with_qp_iters:
        (_, _, dV, ok, _), (ks, Ks, qp_iters) = lax.scan(
            bstep, init, xs, reverse=True)
        return ks, Ks, dV, ok, qp_iters
    (_, _, dV, ok, _), (ks, Ks) = lax.scan(bstep, init, xs, reverse=True)
    return ks, Ks, dV, ok


def backward_stacked(config: DDPConfig, D: StackedDerivs, Vx_T, Vxx_T, lam,
                     D2: StackedSecond | None = None):
    """Backward pass, batch-minor.

    Args: Vx_T [nx, B], Vxx_T [nx, nx, B], lam [B] (per-lane regularization);
    D2 adds the full-DDP second-order curvature terms.
    Returns (ks [N, nu, B], Ks [N, nu, nx, B], dV [2, B], ok [B]).
    """
    nx = D.Fx.shape[1]
    nu = D.Fu.shape[2]
    B = Vx_T.shape[-1]
    dtype = Vx_T.dtype
    eye_nx = jnp.eye(nx, dtype=dtype)[:, :, None]

    reg1 = config.reg_type == 1
    reg2 = config.reg_type == 2
    second = D2 is not None

    def bstep(carry, d):
        Vx, Vxx, dV, ok = carry
        if second:
            (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu), (Fxx, Fuu, Fxu) = d
        else:
            Fx, Fu, Lx, Lu, Lxx, Luu, Lxu = d

        FuT = _mT(Fu)          # [nu, nx, B]
        FxT = _mT(Fx)          # [nx, nx, B]
        Qu = Lu + _mv(FuT, Vx)
        Qx = Lx + _mv(FxT, Vx)
        FuT_Vxx = _mm(FuT, Vxx)
        Qux = _mT(Lxu) + _mm(FuT_Vxx, Fx)
        Quu = Luu + _mm(FuT_Vxx, Fu)
        FxT_Vxx = _mm(FxT, Vxx)
        Qxx = Lxx + _mm(FxT_Vxx, Fx)
        if second:
            # Vx . Fab curvature (DDPSolver.hpp:391-414, stubbed there)
            VxFxu = _vx_dot_f2(Vx, Fxu)   # [nx, nu, B]
            VxFuu = _vx_dot_f2(Vx, Fuu)   # [nu, nu, B]
            VxFxx = _vx_dot_f2(Vx, Fxx)   # [nx, nx, B]
            Qux = Qux + _mT(VxFxu)
            Quu = Quu + VxFuu
            Qxx = Qxx + VxFxx

        if reg2:
            Vxx_reg = Vxx + lam[None, None, :] * eye_nx
            FuT_Vr = _mm(FuT, Vxx_reg)
            Qux_reg = _mT(Lxu) + _mm(FuT_Vr, Fx)
            Quu_F = Luu + _mm(FuT_Vr, Fu)
            if second:
                Qux_reg = Qux_reg + _mT(VxFxu)
                Quu_F = Quu_F + VxFuu
        else:
            Qux_reg = Qux
            Quu_F = Quu
        if reg1:
            Quu_F = Quu_F + lam[None, None, :] * jnp.eye(nu, dtype=dtype)[:, :, None]

        L, ok_i = _chol_bl(Quu_F)
        k = -_chol_solve_bl(L, Qu[:, None, :])[:, 0, :]        # [nu, B]
        K = -_chol_solve_bl(L, Qux_reg)                        # [nu, nx, B]

        Quu_k = _mv(Quu, k)                                    # [nu, B]
        KT = _mT(K)                                            # [nx, nu, B]
        dV = dV + jnp.stack([
            jnp.sum(k * Qu, axis=0),
            0.5 * jnp.sum(k * Quu_k, axis=0),
        ])
        Vx_new = Qx + _mv(KT, Quu_k) + _mv(KT, Qu) + _mv(_mT(Qux), k)
        Vxx_new = (Qxx + _mm(KT, _mm(Quu, K)) + _mm(KT, Qux)
                   + _mm(_mT(Qux), K))
        Vxx_new = 0.5 * (Vxx_new + _mT(Vxx_new))

        return (Vx_new, Vxx_new, dV, ok & ok_i), (k, K)

    init = (Vx_T, Vxx_T, jnp.zeros((2, B), dtype), jnp.ones((B,), dtype=bool))
    xs = (tuple(D), tuple(D2)) if second else tuple(D)
    (_, _, dV, ok), (ks, Ks) = lax.scan(bstep, init, xs, reverse=True)
    return ks, Ks, dV, ok


def stack_derivs(Fx, Fu, Lx, Lu, Lxx, Luu, Lxu) -> StackedDerivs:
    """[B, N, ...] (vmap layout) -> [N, ..., B] (batch-minor layout)."""
    mv = lambda a: jnp.moveaxis(a, 0, -1)
    return StackedDerivs(Fx=mv(Fx), Fu=mv(Fu), Lx=mv(Lx), Lu=mv(Lu),
                         Lxx=mv(Lxx), Luu=mv(Luu), Lxu=mv(Lxu))
