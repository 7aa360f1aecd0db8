"""Batched small-matrix linear algebra, unrolled into elementwise ops.

The solvers factorize tiny (nu x nu, nu <= ~16) SPD matrices inside scan
bodies.  Generic ``jnp.linalg.cholesky`` / ``cho_solve`` lower to LAPACK-ish
kernels that are catastrophically slow for thousands of independent 1x1..8x8
systems on an accelerator (profiled: the DDP backward pass spent ~80% of its time
there).  These routines unroll the factorization/substitution over the
static small dimension, so every operation is a plain elementwise op
batched over all leading axes — the idiomatic accelerator shape for
"many tiny matrices".

Semantics match the reference's Eigen usage:
  * ``cholesky_small`` fails (ok=False) iff a pivot is <= 0 or non-finite —
    Eigen LLT's NumericalIssue (``DDPSolver.hpp:500-508``).
  * ``lu_solve_small`` is Gaussian elimination with partial pivoting — the
    FullPivLU fallback role (``FmpcSolver.hpp:614-617``).
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_small(A):
    """Lower Cholesky of SPD ``A[..., n, n]`` with static small n.

    Returns (L, ok) where ok is the all-pivots-positive flag (batched over
    leading axes).  Failed lanes get safe (identity-ish) factors so no NaN
    poisons neighbouring computations.
    """
    n = A.shape[-1]
    ok = jnp.ones(A.shape[:-2], dtype=bool)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        ok = ok & (d > 0) & jnp.isfinite(d)
        d_safe = jnp.where(d > 0, d, 1.0)
        Ljj = jnp.sqrt(d_safe)
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    rows = [jnp.stack([L[i][j] if j <= i else jnp.zeros_like(A[..., 0, 0])
                       for j in range(n)], axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2), ok


def cho_solve_small(L, B):
    """Solve (L L^T) X = B with ``L`` from :func:`cholesky_small`.

    ``B[..., n]`` or ``B[..., n, m]``; unrolled forward/back substitution."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    n = L.shape[-1]
    # forward: L y = B
    y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y[i] = s / L[..., i, i, None]
    # backward: L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    X = jnp.stack(x, axis=-2)
    return X[..., 0] if vec else X


def solve_psd_small(A, B):
    """(X, ok): solve SPD ``A X = B`` via :func:`cholesky_small`."""
    L, ok = cholesky_small(A)
    return cho_solve_small(L, B), ok


def lu_solve_small(A, B):
    """Solve general ``A X = B`` by unrolled Gaussian elimination with
    partial pivoting (static small n).  ``B[..., n]`` or ``B[..., n, m]``."""
    vec = B.ndim == A.ndim - 1
    if vec:
        B = B[..., None]
    n = A.shape[-1]
    m = B.shape[-1]
    # working rows as lists of [..., n] / [..., m]
    arows = [A[..., i, :] for i in range(n)]
    brows = [B[..., i, :] for i in range(n)]
    for col in range(n):
        # partial pivot: pick max |a[col]| among rows col..n-1 (unrolled swaps)
        for r in range(col + 1, n):
            swap = jnp.abs(arows[r][..., col]) > jnp.abs(arows[col][..., col])
            sw = swap[..., None]
            arows[col], arows[r] = (jnp.where(sw, arows[r], arows[col]),
                                    jnp.where(sw, arows[col], arows[r]))
            brows[col], brows[r] = (jnp.where(sw, brows[r], brows[col]),
                                    jnp.where(sw, brows[col], brows[r]))
        piv = arows[col][..., col]
        piv = jnp.where(piv == 0, 1e-30, piv)
        inv = (1.0 / piv)[..., None]
        for r in range(col + 1, n):
            f = arows[r][..., col, None] * inv
            arows[r] = arows[r] - f * arows[col]
            brows[r] = brows[r] - f * brows[col]
    # back substitution
    x = [None] * n
    for i in reversed(range(n)):
        s = brows[i]
        for k in range(i + 1, n):
            s = s - arows[i][..., k, None] * x[k]
        x[i] = s / arows[i][..., i, None]
    X = jnp.stack(x, axis=-2)
    return X[..., 0] if vec else X
