"""Pallas kernel (Triton route): fused DDP backward pass.

One program runs the whole backward Riccati recursion
(``DDPSolver.hpp:343-534``) for a block of batch lanes: the value-function
carry (Vx, Vxx) stays in registers across all N stages, every small-matrix
contraction is unrolled into elementwise ops on (BLOCK,) lane tiles, and
nothing round-trips device memory between stages.  The XLA stacked
version (kernels/ddp_backward.py) is a ``lax.scan`` whose every stage is a
loop trip of several small kernels over the batch.  Scaffolding (grid,
padding, route) is shared with the other lane kernels in
``kernels/lane_kernel.py``.

Layout contract (the stacked solver's batch-minor layout):
  inputs  Fx [N, nx, nx, B], ..., lam [B]
  outputs ks [N, nu, B], Ks [N, nu, nx, B], dV [2, B], ok [B] (bool)

Numerical semantics are identical to ``backward_stacked`` /
``backward_stacked_boxed`` (same unrolled Cholesky with the Eigen-LLT
pivot>0 failure rule, same BoxQP); parity is tested.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from nmpc_tpu.core.types import DDPConfig
from nmpc_tpu.kernels.lane_kernel import lane_call


def _mm_t(A, B, n, m, k):
    """Unrolled matmul of tile-matrices: A, B are [n][m] / [m][k] nested
    lists of (BLOCK,) tiles -> [n][k] list."""
    return [[sum(A[i][l] * B[l][j] for l in range(m)) for j in range(k)]
            for i in range(n)]


def _mv_t(A, v, n, m):
    return [sum(A[i][l] * v[l] for l in range(m)) for i in range(n)]


def _transpose_t(A, n, m):
    return [[A[i][j] for i in range(n)] for j in range(m)]


def _chol_t(A, n):
    """Unrolled Cholesky on tile-matrices; returns (L, ok_tile as f32 0/1 —
    the kernels keep every mask as a float tile)."""
    ok = None
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j][j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        good = jnp.where((d > 0) & jnp.isfinite(d), 1.0, 0.0).astype(d.dtype)
        ok = good if ok is None else (ok * good)
        Ljj = jnp.sqrt(jnp.where(d > 0, d, 1.0))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L, ok


def _chol_solve_t(L, B, n, m):
    """Solve (L L^T) X = B; B is [n][m] tile-matrix."""
    y = [[None] * m for _ in range(n)]
    for i in range(n):
        for c in range(m):
            s = B[i][c]
            for k in range(i):
                s = s - L[i][k] * y[k][c]
            y[i][c] = s / L[i][i]
    x = [[None] * m for _ in range(n)]
    for i in reversed(range(n)):
        for c in range(m):
            s = y[i][c]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k][c]
            x[i][c] = s / L[i][i]
    return x


def _riccati_stage(config: DDPConfig, nx, nu, lam, zeros, fields, carry):
    """One backward Riccati stage on loaded tile-fields (shared by the
    sweep-fed and remat kernels).  ``fields`` maps name -> tile-matrix /
    tile-vector; ``carry`` is (Vx, Vxx, dV0, dV1, ok).  Returns
    (new_carry, kvec, K)."""
    reg1 = config.reg_type == 1
    reg2 = config.reg_type == 2
    Vx, Vxx, dV0, dV1, ok = carry
    Fx, Fu = fields["Fx"], fields["Fu"]
    Lx, Lu = fields["Lx"], fields["Lu"]
    Lxx, Luu, Lxu = fields["Lxx"], fields["Luu"], fields["Lxu"]

    FuT = _transpose_t(Fu, nx, nu)
    FxT = _transpose_t(Fx, nx, nx)
    Qu = [Lu[a] + s for a, s in enumerate(_mv_t(FuT, Vx, nu, nx))]
    Qx = [Lx[a] + s for a, s in enumerate(_mv_t(FxT, Vx, nx, nx))]
    FuT_Vxx = _mm_t(FuT, Vxx, nu, nx, nx)
    LxuT = _transpose_t(Lxu, nx, nu)
    M = _mm_t(FuT_Vxx, Fx, nu, nx, nx)
    Qux = [[LxuT[a][b] + M[a][b] for b in range(nx)] for a in range(nu)]
    M = _mm_t(FuT_Vxx, Fu, nu, nx, nu)
    Quu = [[Luu[a][b] + M[a][b] for b in range(nu)] for a in range(nu)]
    FxT_Vxx = _mm_t(FxT, Vxx, nx, nx, nx)
    M = _mm_t(FxT_Vxx, Fx, nx, nx, nx)
    Qxx = [[Lxx[a][b] + M[a][b] for b in range(nx)] for a in range(nx)]

    if reg2:
        Vxx_reg = [[Vxx[a][b] + (lam if a == b else zeros)
                    for b in range(nx)] for a in range(nx)]
        FuT_Vr = _mm_t(FuT, Vxx_reg, nu, nx, nx)
        M = _mm_t(FuT_Vr, Fx, nu, nx, nx)
        Qux_reg = [[LxuT[a][b] + M[a][b] for b in range(nx)]
                   for a in range(nu)]
        M = _mm_t(FuT_Vr, Fu, nu, nx, nu)
        Quu_F = [[Luu[a][b] + M[a][b] for b in range(nu)]
                 for a in range(nu)]
    else:
        Qux_reg = Qux
        Quu_F = [row[:] for row in Quu]
    if reg1:
        Quu_F = [[Quu_F[a][b] + (lam if a == b else zeros)
                  for b in range(nu)] for a in range(nu)]

    L, ok_i = _chol_t(Quu_F, nu)
    kvec = [-v[0] for v in _chol_solve_t(L, [[q] for q in Qu], nu, 1)]
    Ksol = _chol_solve_t(L, Qux_reg, nu, nx)
    K = [[-Ksol[a][b] for b in range(nx)] for a in range(nu)]

    Quu_k = _mv_t(Quu, kvec, nu, nu)
    KT = _transpose_t(K, nu, nx)
    QuxT = _transpose_t(Qux, nu, nx)
    dV0 = dV0 + sum(kvec[a] * Qu[a] for a in range(nu))
    dV1 = dV1 + 0.5 * sum(kvec[a] * Quu_k[a] for a in range(nu))

    t1 = _mv_t(KT, Quu_k, nx, nu)
    t2 = _mv_t(KT, Qu, nx, nu)
    t3 = _mv_t(QuxT, kvec, nx, nu)
    Vx_new = [Qx[a] + t1[a] + t2[a] + t3[a] for a in range(nx)]

    KTQuu = _mm_t(KT, Quu, nx, nu, nu)
    T1 = _mm_t(KTQuu, K, nx, nu, nx)
    T2 = _mm_t(KT, Qux, nx, nu, nx)
    Vxx_new = [[Qxx[a][b] + T1[a][b] + T2[a][b] + T2[b][a]
                for b in range(nx)] for a in range(nx)]
    Vxx_sym = [[0.5 * (Vxx_new[a][b] + Vxx_new[b][a])
                for b in range(nx)] for a in range(nx)]

    return (Vx_new, Vxx_sym, dV0, dV1, ok * ok_i), kvec, K


def _boxqp_t(H, gq, lo, hi, x0, nu, bq, zeros):
    """Projected-Newton BoxQP on (BLOCK,) tiles — the fused in-kernel
    analog of ``kernels/ddp_backward.boxqp_stacked`` (reference
    ``BoxQP.h:141-347``), with IDENTICAL semantics:

    - QP iterations: ``min(unroll_iter, max_iter)`` iterations unrolled
      (straight-line code, no loop), then a masked ``lax.while_loop``
      continuation up to ``max_iter`` for the rare lanes needing more —
      the same unroll+continuation split as ``boxqp_stacked``.  A lane
      reaching ``max_iter`` exits MAX_ITER = success, like the stacked
      path and the reference (``BoxQP.h:332-336``).
    - Armijo backtracking: the first ``ls_block`` candidates unrolled
      (first-stop select — in practice every accept lands here), then a
      masked ``lax.while_loop`` tail over the rest of the schedule; a
      lane exhausting the schedule without an accept takes the
      LAST-VISITED candidate and exits MAX_LS_ITER, exactly like the
      stacked kernel (and the reference's tiny-step accept,
      ``BoxQP.h:298-309``).
    - All selections use ``jnp.where`` (bit-exact), never arithmetic
      masking: a selected candidate must compare ``==`` against the
      bounds in the next iteration's clamped-set test.

    H [nu][nu] tiles (the regularized Quu_F), gq/lo/hi/x0 [nu] tiles.
    Returns (x, ok, free, L) with free/L taken from the exit iteration
    (the previous iteration's on a small-improvement exit), matching the
    stacked kernel's ``keep_prev`` rule.
    """
    import numpy as np

    ones = jnp.ones_like(zeros)
    dtype = zeros.dtype

    def f01(cond):
        return jnp.where(cond, 1.0, 0.0).astype(dtype)

    def sel(mask, a, b):
        """jnp.where on an f32 0/1 mask — bit-exact select."""
        return jnp.where(mask > 0, a, b)

    def clipv(v, lo_i, hi_i):
        return jnp.minimum(jnp.maximum(v, lo_i), hi_i)

    def obj_of(xv):
        Hx = _mv_t(H, xv, nu, nu)
        return (sum(gq[i] * xv[i] for i in range(nu))
                + 0.5 * sum(xv[i] * Hx[i] for i in range(nu)))

    # fp32-exact step schedule: repeated multiplication like the
    # reference's sequential loop (and the stacked kernel's cumprod)
    n_ls = bq.max_ls_iter + 1
    K1 = min(bq.ls_block, n_ls)
    steps, s = [], np.float32(1.0)
    for _ in range(n_ls):
        steps.append(float(s))
        s = np.float32(s * np.float32(bq.step_factor))

    ntri = nu * (nu + 1) // 2

    def tri_flat(L):
        return [L[i][j] for i in range(nu) for j in range(i + 1)]

    def tri_unflat(flat):
        out = [[zeros] * nu for _ in range(nu)]
        k = 0
        for i in range(nu):
            for j in range(i + 1):
                out[i][j] = flat[k]
                k += 1
        return out

    def qp_iter(x, obj, old_obj, active, ok, free_keep, L_keep, first):
        """One masked projected-Newton iteration (mirror of
        ``boxqp_stacked``'s body)."""
        if first:
            imp = zeros
        else:
            imp = f01((old_obj - obj)
                      < bq.rel_improve_thre * jnp.abs(old_obj))
        old_obj = sel(active, obj, old_obj)

        Hx = _mv_t(H, x, nu, nu)
        grad = [gq[i] + Hx[i] for i in range(nu)]
        clamped = [f01(((x[i] == lo[i]) & (grad[i] > 0))
                       | ((x[i] == hi[i]) & (grad[i] < 0)))
                   for i in range(nu)]
        free = [1.0 - clamped[i] for i in range(nu)]
        all_clamped = clamped[0]
        for i in range(1, nu):
            all_clamped = all_clamped * clamped[i]

        Hm = [[free[i] * free[j] * H[i][j]
               + (clamped[i] if i == j else zeros)
               for j in range(nu)] for i in range(nu)]
        L, okc = _chol_t(Hm, nu)

        gn2 = sum(free[i] * grad[i] * grad[i] for i in range(nu))
        small_grad = f01(gn2 < bq.grad_thre ** 2)

        cmx = [clamped[j] * x[j] for j in range(nu)]
        Hcm = _mv_t(H, cmx, nu, nu)
        rhs = [[free[i] * (gq[i] + Hcm[i])] for i in range(nu)]
        sol = _chol_solve_t(L, rhs, nu, 1)
        d = [free[i] * (-sol[i][0] - free[i] * x[i]) for i in range(nu)]
        sdg = sum(d[i] * grad[i] for i in range(nu))
        bad_dir = f01(sdg > 1e-10)

        pre_exit = jnp.maximum(
            jnp.maximum(jnp.maximum(imp, all_clamped),
                        jnp.maximum(1.0 - okc, small_grad)), bad_dir)

        # ---- Armijo head: first K1 candidates unrolled, first-stop ----
        found = zeros      # stopped (accept, or below-min_step forced)
        exh = zeros        # stopped without a true Armijo accept
        xa = [x[i] for i in range(nu)]
        obja = obj
        xl, objl = xa, obja          # last-visited candidate
        head_hit_min = False
        for idx in range(K1):
            sv = steps[idx]
            below = sv < bq.min_step  # static
            xc = [clipv(x[i] + sv * d[i], lo[i], hi[i]) for i in range(nu)]
            objc = obj_of(xc)
            acc = f01((objc - old_obj) / (sv * sdg) >= bq.armijo_param)
            stop = ones if below else acc
            take = stop * (1.0 - found)
            xa = [sel(take, xc[i], xa[i]) for i in range(nu)]
            obja = sel(take, objc, obja)
            if below:
                # below-min_step stop = exhaustion regardless of Armijo
                # (BoxQP.h:304-308; matches boxqp_stacked / boxqp_solve —)
                exh = jnp.maximum(exh, take)
            found = jnp.maximum(found, stop)
            xl, objl = xc, objc
            if below:
                head_hit_min = True
                break

        if head_hit_min or K1 >= n_ls:
            # the head covered the whole schedule: no-stop lanes take the
            # last-visited candidate with the exhaustion exit
            nt = 1.0 - found
            xa = [sel(nt, xl[i], xa[i]) for i in range(nu)]
            obja = sel(nt, objl, obja)
            exh = jnp.maximum(exh, nt)
        else:
            # ---- masked sequential tail over the rest of the schedule;
            # zero trips in the common case ----
            need_tail = active * (1.0 - pre_exit) * (1.0 - found)

            def ls_cond(st):
                k, _, done = st[0], st[1], st[2]
                return (jnp.sum(1.0 - done) > 0) & (k < n_ls)

            def ls_body(st):
                k, step, done, exh_t, obja_t = st[:5]
                xt = list(st[5:])
                step = step * np.float32(bq.step_factor)
                xc = [clipv(x[i] + step * d[i], lo[i], hi[i])
                      for i in range(nu)]
                objc = obj_of(xc)
                acc = f01((objc - old_obj) / (step * sdg)
                          >= bq.armijo_param)
                # vector predicate: a scalar-predicate select does not
                # lower on the Triton route
                belf = f01(step * ones < np.float32(bq.min_step))
                upd = 1.0 - done
                # track the last-visited candidate for every undone lane:
                # its stop candidate when it stops, the schedule's last
                # candidate on exhaustion (BoxQP.h:298-309 accepts the
                # last — tiniest — candidate)
                xt = [sel(upd, xc[i], xt[i]) for i in range(nu)]
                obja_t = sel(upd, objc, obja_t)
                stopf = jnp.maximum(acc, belf) * upd
                # below-min_step stop = exhaustion regardless of Armijo
                # (BoxQP.h:304-308)
                exh_t = jnp.maximum(exh_t, stopf * belf)
                done = jnp.maximum(done, stopf)
                return (k + 1, step, done, exh_t, obja_t, *xt)

            st = (jnp.int32(K1), jnp.float32(steps[K1 - 1]),
                  1.0 - need_tail, zeros, obja, *xa)
            st = lax.while_loop(ls_cond, ls_body, st)
            done_f, exh_t, obja = st[2], st[3], st[4]
            xa = list(st[5:])
            # lanes exhausting the schedule (still undone) hold the
            # last-visited candidate in xa; flag them exhausted
            exh = jnp.maximum(exh, jnp.maximum(exh_t, 1.0 - done_f))

        take_step = active * (1.0 - pre_exit)
        x = [sel(take_step, xa[i], x[i]) for i in range(nu)]
        obj = sel(take_step, obja, obj)

        keep_new = active * (1.0 - imp)
        free_keep = [sel(keep_new, free[i], free_keep[i])
                     for i in range(nu)]
        L_keep = [[sel(keep_new, L[i][j], L_keep[i][j])
                   if j <= i else zeros for j in range(nu)]
                  for i in range(nu)]

        fail = active * jnp.maximum(1.0 - okc, bad_dir)
        ok = ok * (1.0 - fail)
        # exhaustion terminates the lane (MAX_LS_ITER, a success code);
        # accepted lanes keep iterating
        done_now = jnp.maximum(pre_exit, exh)
        active = active * (1.0 - done_now)
        return x, obj, old_obj, active, ok, free_keep, L_keep

    x = [clipv(x0[i], lo[i], hi[i]) for i in range(nu)]
    obj = obj_of(x)
    old_obj = obj
    active = ones
    ok = ones
    free_keep = [ones for _ in range(nu)]
    L_keep = [[ones if i == j else zeros for j in range(nu)]
              for i in range(nu)]

    n_unroll = max(1, min(bq.unroll_iter, bq.max_iter))
    for it in range(1, n_unroll + 1):
        x, obj, old_obj, active, ok, free_keep, L_keep = qp_iter(
            x, obj, old_obj, active, ok, free_keep, L_keep,
            first=(it == 1))

    if n_unroll < bq.max_iter:
        # masked while continuation to max_iter — exact stacked semantics
        # (a lane still active at the cap exits MAX_ITER = success)
        def qp_cond(c):
            it, act = c[0], c[3 + nu]
            return (jnp.sum(act) > 0) & (it < bq.max_iter)

        def qp_body(c):
            it = c[0]
            xs = list(c[1:1 + nu])
            objv, old = c[1 + nu], c[2 + nu]
            act, okv = c[3 + nu], c[4 + nu]
            fks = list(c[5 + nu:5 + 2 * nu])
            Lk = tri_unflat(list(c[5 + 2 * nu:5 + 2 * nu + ntri]))
            xs, objv, old, act, okv, fks, Lk = qp_iter(
                xs, objv, old, act, okv, fks, Lk, first=False)
            return (it + 1, *xs, objv, old, act, okv, *fks,
                    *tri_flat(Lk))

        c0 = (jnp.int32(n_unroll), *x, obj, old_obj, active, ok,
              *free_keep, *tri_flat(L_keep))
        c = lax.while_loop(qp_cond, qp_body, c0)
        x = list(c[1:1 + nu])
        ok = c[4 + nu]
        free_keep = list(c[5 + nu:5 + 2 * nu])
        L_keep = tri_unflat(list(c[5 + 2 * nu:5 + 2 * nu + ntri]))

    return x, ok, free_keep, L_keep


def _riccati_stage_boxed(config: DDPConfig, nx, nu, lam, zeros, fields,
                         carry):
    """One boxed backward Riccati stage on loaded tile-fields: Q expansion
    as in :func:`_riccati_stage`, gains via the in-kernel BoxQP
    (``DDPSolver.hpp:450-497``).  ``carry`` adds the next stage's
    feedforward ``k_next`` as the QP warm start."""
    reg1 = config.reg_type == 1
    reg2 = config.reg_type == 2
    Vx, Vxx, dV0, dV1, ok, k_next = carry
    Fx, Fu = fields["Fx"], fields["Fu"]
    Lx, Lu = fields["Lx"], fields["Lu"]
    Lxx, Luu, Lxu = fields["Lxx"], fields["Luu"], fields["Lxu"]
    lower, upper, u = fields["lower"], fields["upper"], fields["u"]

    FuT = _transpose_t(Fu, nx, nu)
    FxT = _transpose_t(Fx, nx, nx)
    Qu = [Lu[a] + s for a, s in enumerate(_mv_t(FuT, Vx, nu, nx))]
    Qx = [Lx[a] + s for a, s in enumerate(_mv_t(FxT, Vx, nx, nx))]
    FuT_Vxx = _mm_t(FuT, Vxx, nu, nx, nx)
    LxuT = _transpose_t(Lxu, nx, nu)
    M = _mm_t(FuT_Vxx, Fx, nu, nx, nx)
    Qux = [[LxuT[a][b] + M[a][b] for b in range(nx)] for a in range(nu)]
    M = _mm_t(FuT_Vxx, Fu, nu, nx, nu)
    Quu = [[Luu[a][b] + M[a][b] for b in range(nu)] for a in range(nu)]
    FxT_Vxx = _mm_t(FxT, Vxx, nx, nx, nx)
    M = _mm_t(FxT_Vxx, Fx, nx, nx, nx)
    Qxx = [[Lxx[a][b] + M[a][b] for b in range(nx)] for a in range(nx)]

    if reg2:
        Vxx_reg = [[Vxx[a][b] + (lam if a == b else zeros)
                    for b in range(nx)] for a in range(nx)]
        FuT_Vr = _mm_t(FuT, Vxx_reg, nu, nx, nx)
        M = _mm_t(FuT_Vr, Fx, nu, nx, nx)
        Qux_reg = [[LxuT[a][b] + M[a][b] for b in range(nx)]
                   for a in range(nu)]
        M = _mm_t(FuT_Vr, Fu, nu, nx, nu)
        Quu_F = [[Luu[a][b] + M[a][b] for b in range(nu)]
                 for a in range(nu)]
    else:
        Qux_reg = Qux
        Quu_F = [row[:] for row in Quu]
    if reg1:
        Quu_F = [[Quu_F[a][b] + (lam if a == b else zeros)
                  for b in range(nu)] for a in range(nu)]

    lo_rel = [lower[i] - u[i] for i in range(nu)]
    hi_rel = [upper[i] - u[i] for i in range(nu)]
    kvec, ok_qp, freem, Lq = _boxqp_t(
        Quu_F, Qu, lo_rel, hi_rel, k_next, nu, config.boxqp, zeros)

    # K rows: free rows solve H_free K_free = -Qux_reg_free on the masked
    # factorization; clamped rows are zero (DDPSolver.hpp:482-496)
    rhs = [[freem[a] * Qux_reg[a][b] for b in range(nx)] for a in range(nu)]
    Ksol = _chol_solve_t(Lq, rhs, nu, nx)
    K = [[-freem[a] * Ksol[a][b] for b in range(nx)] for a in range(nu)]

    Quu_k = _mv_t(Quu, kvec, nu, nu)
    KT = _transpose_t(K, nu, nx)
    QuxT = _transpose_t(Qux, nu, nx)
    dV0 = dV0 + sum(kvec[a] * Qu[a] for a in range(nu))
    dV1 = dV1 + 0.5 * sum(kvec[a] * Quu_k[a] for a in range(nu))

    t1 = _mv_t(KT, Quu_k, nx, nu)
    t2 = _mv_t(KT, Qu, nx, nu)
    t3 = _mv_t(QuxT, kvec, nx, nu)
    Vx_new = [Qx[a] + t1[a] + t2[a] + t3[a] for a in range(nx)]

    KTQuu = _mm_t(KT, Quu, nx, nu, nu)
    T1 = _mm_t(KTQuu, K, nx, nu, nx)
    T2 = _mm_t(KT, Qux, nx, nu, nx)
    Vxx_new = [[Qxx[a][b] + T1[a][b] + T2[a][b] + T2[b][a]
                for b in range(nx)] for a in range(nx)]
    Vxx_sym = [[0.5 * (Vxx_new[a][b] + Vxx_new[b][a])
                for b in range(nx)] for a in range(nx)]

    return ((Vx_new, Vxx_sym, dV0, dV1, ok * ok_qp, kvec), kvec, K)


_DERIV_FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Luu", "Lxu")
_BOUND_FIELDS = ("lower", "upper", "u")


def load_mat(ref, i, n, m):
    """Tile-matrix [n][m] of stage ``i`` from a [N, n, m, BLOCK] ref."""
    return [[ref[i, a, b] for b in range(m)] for a in range(n)]


def load_vec(ref, i, n):
    """Tile-vector [n] of stage ``i`` from a [N, n, BLOCK] ref."""
    return [ref[i, a] for a in range(n)]


def riccati_loop(config: DDPConfig, nx, nu, N, boxed, stage_fields,
                 VxT_ref, VxxT_ref, lam_ref, ks_ref, Ks_ref, dV_ref, ok_ref):
    """The reversed stage loop shared by the sweep-fed and remat kernels:
    ``stage_fields(i)`` returns stage i's Riccati fields as tiles."""
    lam = lam_ref[...]
    zeros = jnp.zeros_like(lam)
    Vx = [VxT_ref[a] for a in range(nx)]
    Vxx = [[VxxT_ref[a, b] for b in range(nx)] for a in range(nx)]
    carry0 = (Vx, Vxx, zeros, zeros, jnp.ones_like(lam))
    if boxed:
        carry0 = carry0 + ([zeros for _ in range(nu)],)  # k_next warm start

    def body(j, carry):
        i = N - 1 - j
        fields = stage_fields(i)
        if boxed:
            new_carry, kvec, K = _riccati_stage_boxed(
                config, nx, nu, lam, zeros, fields, carry)
        else:
            new_carry, kvec, K = _riccati_stage(
                config, nx, nu, lam, zeros, fields, carry)
        for a in range(nu):
            ks_ref[i, a] = kvec[a]
            for b in range(nx):
                Ks_ref[i, a, b] = K[a][b]
        return new_carry

    out = lax.fori_loop(0, N, body, carry0)
    dV_ref[0] = out[2]
    dV_ref[1] = out[3]
    ok_ref[...] = out[4]


def riccati_out_shapes(nx, nu, N, dtype):
    return [((N, nu), dtype), ((N, nu, nx), dtype), ((2,), dtype),
            ((), jnp.float32)]


def _backward_call(config: DDPConfig, D, bounds, Vx_T, Vxx_T, lam, name):
    N, nx = D.Fx.shape[0], D.Fx.shape[1]
    nu = D.Fu.shape[2]
    boxed = bounds is not None
    names = _DERIV_FIELDS + (_BOUND_FIELDS if boxed else ())
    arrays = list(D) + (list(bounds) if boxed else [])
    shapes = {"Fx": (nx, nx), "Fu": (nx, nu), "Lx": (nx,), "Lu": (nu,),
              "Lxx": (nx, nx), "Luu": (nu, nu), "Lxu": (nx, nu),
              "lower": (nu,), "upper": (nu,), "u": (nu,)}
    nf = len(names)

    def kernel(*refs):
        field_refs = dict(zip(names, refs[:nf]))
        VxT_ref, VxxT_ref, lam_ref = refs[nf:nf + 3]

        def stage_fields(i):
            out = {}
            for n in names:
                s = shapes[n]
                out[n] = (load_mat(field_refs[n], i, *s) if len(s) == 2
                          else load_vec(field_refs[n], i, s[0]))
            return out

        riccati_loop(config, nx, nu, N, boxed, stage_fields,
                     VxT_ref, VxxT_ref, lam_ref, *refs[nf + 3:])

    ks, Ks, dV, okf = lane_call(
        kernel, name=name, inputs=arrays + [Vx_T, Vxx_T, lam],
        out_shapes=riccati_out_shapes(nx, nu, N, D.Fx.dtype))
    return ks, Ks, dV, okf > 0.5


def backward_pallas(config: DDPConfig, D, Vx_T, Vxx_T, lam):
    """Drop-in for ``backward_stacked`` (same signature and batch-minor
    layout, any B) backed by the fused kernel."""
    return _backward_call(config, D, None, Vx_T, Vxx_T, lam,
                          "ddp_backward")


def backward_pallas_boxed(config: DDPConfig, D, bounds, Vx_T, Vxx_T, lam):
    """Drop-in for ``backward_stacked_boxed`` backed by the fused boxed
    kernel: the whole backward recursion INCLUDING the per-stage
    projected-Newton BoxQP (``DDPSolver.hpp:450-497`` +
    ``BoxQP.h:141-347``) runs as one program per lane block, with the
    value-function carry and the QP warm start in registers.

    The in-kernel BoxQP runs the SAME semantics as ``boxqp_stacked``
    (unrolled head plus masked while-loop continuations for the QP
    iterations and the Armijo schedule), so agreement is exact in the
    interpreter and at fp reassociation level compiled."""
    return _backward_call(config, D, bounds, Vx_T, Vxx_T, lam,
                          "ddp_backward_boxed")
