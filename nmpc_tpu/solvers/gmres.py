"""Matrix-free GMRES with Givens-rotation triangularization, batched in XLA.

Algorithmic equivalent of the reference ``nmpc_cgmres::Gmres``
(``nmpc_cgmres/include/nmpc_cgmres/Gmres.h:42-192``; Kelley 1995, Alg. 3.5.1):
Arnoldi with modified Gram-Schmidt, conditional reorthogonalization
(``Gmres.h:117-130``), Givens triangularization of the Hessenberg column
(``Gmres.h:136-168``), residual tracked as |g[k]|, early exit at
rho <= eps * ||b||.

Static-shape redesign: fixed-shape workspace ([k_max+1, n] basis, [k_max+1, k_max]
Hessenberg) with a ``lax.while_loop`` over Arnoldi iterations — one operator
application per iteration, inner recurrences as masked ``fori_loop``.  Under
``vmap`` this batches across independent systems, which is how the C/GMRES
continuation runs thousands of controllers per chip.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class GmresResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray        # Arnoldi iterations performed
    residual: jnp.ndarray     # final residual estimate rho
    err_history: jnp.ndarray  # [k_max+1] residuals (reference err_list_)


def gmres(
    Amul: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    k_max: int,
    eps: float = 1e-10,
    reorth: bool = True,
    make_triangular: bool = True,
) -> GmresResult:
    """Solve A x = b given the matrix-free product ``Amul(v) = A @ v``.

    Matches ``Gmres::solve`` (``Gmres.h:67-192``) semantics, including the
    floating-point reorthogonalization trigger
    ``Avk_norm + 1e-3 * h == Avk_norm``.

    ``make_triangular=True`` is Kelley Alg. 3.5.1 (incremental Givens
    triangularization, ``Gmres.h:136-168``); ``False`` is Alg. 3.4.2: a
    Householder-QR least-squares solve of the growing Hessenberg each
    iteration with the true residual norm (``Gmres.h:170-176``).
    """
    n = b.shape[0]
    dtype = b.dtype
    k_max = min(k_max, n)

    r = b - Amul(x0)
    rho0 = jnp.linalg.norm(r)
    b_norm = jnp.linalg.norm(b)

    V = jnp.zeros((k_max + 1, n), dtype).at[0].set(
        jnp.where(rho0 > 0, r / rho0, r))
    H = jnp.zeros((k_max + 1, k_max), dtype)
    g = jnp.zeros((k_max + 1,), dtype).at[0].set(rho0)
    cs = jnp.zeros((k_max,), dtype)
    sn = jnp.zeros((k_max,), dtype)
    errs = jnp.full((k_max + 1,), jnp.nan, dtype).at[0].set(rho0)
    # unit subdiagonal used to pad inactive Hessenberg columns in the
    # least-squares mode (keeps the padded QR nonsingular and exactly
    # equivalent to the truncated system)
    _sub = jnp.eye(k_max + 1, k_max, k=-1, dtype=dtype)

    class Carry(NamedTuple):
        k: jnp.ndarray
        V: jnp.ndarray
        H: jnp.ndarray
        g: jnp.ndarray
        cs: jnp.ndarray
        sn: jnp.ndarray
        rho: jnp.ndarray
        errs: jnp.ndarray
        y: jnp.ndarray

    def cond(c: Carry):
        return (c.rho > eps * b_norm) & (c.k < k_max)

    def body(c: Carry):
        k = c.k  # 0-based Arnoldi index; reference's k-1
        w = Amul(c.V[k])
        Avk_norm = jnp.linalg.norm(w)

        # modified Gram-Schmidt against basis vectors 0..k (Gmres.h:100-110)
        def mgs(j, carry):
            w, hcol = carry
            active = j <= k
            h = jnp.where(active, w @ c.V[j], 0.0)
            w = w - h * c.V[j]
            return (w, hcol.at[j].set(h))

        w, hcol = lax.fori_loop(0, k_max + 1, mgs,
                                (w, jnp.zeros((k_max + 1,), dtype)))
        new_norm = jnp.linalg.norm(w)

        # conditional reorthogonalization (Gmres.h:117-130)
        if reorth:
            need = (Avk_norm + 1e-3 * new_norm) == Avk_norm

            def mgs2(j, carry):
                w, hcol = carry
                active = (j <= k) & need
                h = jnp.where(active, w @ c.V[j], 0.0)
                w = w - h * c.V[j]
                return (w, hcol.at[j].add(h))

            w, hcol = lax.fori_loop(0, k_max + 1, mgs2, (w, hcol))
            new_norm = jnp.where(need, jnp.linalg.norm(w), new_norm)

        hcol = hcol.at[k + 1].set(new_norm)
        V = c.V.at[k + 1].set(jnp.where(new_norm > 0, w / new_norm, w))

        if make_triangular:
            # apply previous Givens rotations to the new column (Gmres.h:139-148)
            def rot(j, hcol):
                active = j < k
                h0, h1 = hcol[j], hcol[j + 1]
                cj = jnp.where(active, c.cs[j], 1.0)
                sj = jnp.where(active, c.sn[j], 0.0)
                return hcol.at[j].set(cj * h0 - sj * h1).at[j + 1].set(
                    sj * h0 + cj * h1)

            hcol = lax.fori_loop(0, k_max, rot, hcol)

            # new rotation zeroing the subdiagonal (Gmres.h:150-160)
            nu = jnp.sqrt(hcol[k] ** 2 + hcol[k + 1] ** 2)
            ck = jnp.where(nu > 0, hcol[k] / nu, 1.0)
            sk = jnp.where(nu > 0, -hcol[k + 1] / nu, 0.0)
            hcol = hcol.at[k].set(ck * hcol[k] - sk * hcol[k + 1]).at[k + 1].set(0.0)

            g0, g1 = c.g[k], c.g[k + 1]
            gnew = c.g.at[k].set(ck * g0 - sk * g1).at[k + 1].set(sk * g0 + ck * g1)
            rho = jnp.abs(gnew[k + 1])
            Hnew = c.H.at[:, k].set(hcol[: k_max + 1])
            ynew = c.y

        else:
            # least-squares mode (Kelley Alg. 3.4.2, Gmres.h:170-176):
            # Householder-QR solve of the (k+2, k+1) Hessenberg block each
            # iteration; rho is the true LS residual.  Fixed-shape: pad
            # inactive columns with a unit subdiagonal (their y entries
            # solve rows whose rhs is zero -> exactly 0).
            Hnew = c.H.at[:, k].set(hcol[: k_max + 1])
            rowm = jnp.arange(k_max + 1) < k + 2
            colm = jnp.arange(k_max) < k + 1
            Hm = (Hnew * (rowm[:, None] & colm[None, :])
                  + _sub * (~colm)[None, :])
            rhs = jnp.where(rowm, c.g, 0.0)
            q, r_ = jnp.linalg.qr(Hm)
            ynew = jax.scipy.linalg.solve_triangular(r_, q.T @ rhs,
                                                     lower=False)
            rho = jnp.linalg.norm(rhs - Hm @ ynew)
            gnew = c.g
            ck = sk = jnp.zeros((), dtype)

        return Carry(
            k=k + 1,
            V=V,
            H=Hnew,
            g=gnew,
            cs=c.cs.at[k].set(ck),
            sn=c.sn.at[k].set(sk),
            rho=rho,
            errs=c.errs.at[k + 1].set(rho),
            y=ynew,
        )

    out = lax.while_loop(cond, body, Carry(jnp.int32(0), V, H, g, cs, sn,
                                           rho0, errs,
                                           jnp.zeros((k_max,), dtype)))

    if make_triangular:
        # back-substitution on the k x k upper-triangular block
        # (Gmres.h:181-184); masked: rows >= k get unit diagonal and zero
        # rhs -> y = 0.
        k = out.k
        idx = jnp.arange(k_max)
        active = idx < k
        Ht = out.H[:k_max, :]
        Ht = jnp.where(active[:, None] & active[None, :], Ht, 0.0)
        Ht = Ht + jnp.diag(jnp.where(active, 0.0, 1.0))
        rhs = jnp.where(active, out.g[:k_max], 0.0)
        y = jax.scipy.linalg.solve_triangular(Ht, rhs, lower=False)
    else:
        # the last iteration's LS solution (reference uses y_k from the
        # final loop pass, Gmres.h:186-190)
        y = out.y

    x = x0 + out.V[:k_max].T @ y
    return GmresResult(x=x, iters=out.k, residual=out.rho,
                       err_history=out.errs)


def gmres_dense(
    A: jnp.ndarray,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    k_max: int,
    eps: float = 1e-10,
    reorth: bool = True,
    make_triangular: bool = True,
) -> GmresResult:
    """Dense-matrix convenience overload (reference ``Gmres.h:42-52``):
    forwards ``Amul(v) = A @ v`` to the matrix-free solver."""
    return gmres(lambda v: A @ v, b, x0, k_max, eps=eps, reorth=reorth,
                 make_triangular=make_triangular)
