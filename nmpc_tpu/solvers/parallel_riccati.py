"""Parallel-in-time Riccati / LQR solver via associative scan.

The Riccati recursion is a linear chain (``DDPSolver.hpp:367``,
``FmpcSolver.hpp:551``) — O(N) sequential depth.  For long horizons the
accelerator-native alternative is temporal parallelization: the backward value
recursion is a composition of *Riccati flows*, which are closed under
composition and associative, so ``jax.lax.associative_scan`` evaluates all
suffix value functions in O(log N) depth (cf. Särkkä & García-Fernández,
"Temporal parallelization of Bayesian smoothers", and the parallel-LQT
literature referenced in PAPERS.md: arXiv:1809.06360, arXiv:1407.6898).

Formulation (clean-room):
  * The affine-quadratic problem is homogenized on the extended state
    z = [x; 1]:  z' = Az z + Bz u, cost 1/2 z'Qz z + u'Mz' z + 1/2 u'R u.
  * Cross terms are removed by completing the square
    (u = u_hat - R^{-1} Mz z), leaving the cross-free flow
        phi(S) = J + F' S (I + C S)^{-1} F,
    with per-stage F = Az - Bz R^{-1} Mz, C = Bz R^{-1} Bz',
    J = Qz - Mz' R^{-1} Mz.
  * Riccati flows compose:  (phi_a o phi_b)(S) = phi_ab(S) with
        E    = (I + C_a J_b)^{-1}
        F_ab = F_b E F_a
        C_ab = C_b + F_b E C_a F_b'
        J_ab = J_a + F_a' J_b E F_a
    which is associative — the element of the scan.
  * Suffix compositions give S_i for every stage simultaneously; gains are
    then recovered stagewise (embarrassingly parallel) and un-shifted back
    through the square completion: u = K x + k.

Note on DDP: the reference's LM regularization adds lambda only to the
*gain* solve (``DDPSolver.hpp:438-441``) while the value recursion uses
unregularized terms — a split a composed flow cannot represent exactly.
This module therefore targets (a) exact LQR/LQT subproblems and (b)
long-horizon MPC where lambda ~ 0 at convergence; parity with the
sequential recursion is exact in those regimes (tested).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LQRStage(NamedTuple):
    """Affine-quadratic stage data (all leading axis N unless noted).

    Dynamics x' = A x + B u + c; cost
    1/2 x'Qxx x + q'x + 1/2 u'Quu u + r'u + u'Qux x.
    """

    A: jnp.ndarray     # [N, nx, nx]
    B: jnp.ndarray     # [N, nx, nu]
    c: jnp.ndarray     # [N, nx]
    Qxx: jnp.ndarray   # [N, nx, nx]
    Quu: jnp.ndarray   # [N, nu, nu]
    Qux: jnp.ndarray   # [N, nu, nx]
    q: jnp.ndarray     # [N, nx]
    r: jnp.ndarray     # [N, nu]


def _extend(stage: LQRStage):
    """Homogenize on z = [x; 1] and complete the square.

    Returns (F, C, J) flow elements [N, nz, nz] plus (Az, Bz, Mz, Quu)
    needed for gain recovery."""
    N, nx, nu = stage.B.shape
    nz = nx + 1
    dtype = stage.A.dtype

    Az = jnp.zeros((N, nz, nz), dtype)
    Az = Az.at[:, :nx, :nx].set(stage.A)
    Az = Az.at[:, :nx, nx].set(stage.c)
    Az = Az.at[:, nx, nx].set(1.0)

    Bz = jnp.zeros((N, nz, nu), dtype)
    Bz = Bz.at[:, :nx, :].set(stage.B)

    Qz = jnp.zeros((N, nz, nz), dtype)
    Qz = Qz.at[:, :nx, :nx].set(stage.Qxx)
    Qz = Qz.at[:, :nx, nx].set(stage.q)
    Qz = Qz.at[:, nx, :nx].set(stage.q)

    Mz = jnp.zeros((N, nu, nz), dtype)
    Mz = Mz.at[:, :, :nx].set(stage.Qux)
    Mz = Mz.at[:, :, nx].set(stage.r)

    Rinv_M = jnp.linalg.solve(stage.Quu, Mz)            # [N, nu, nz]
    F = Az - jnp.einsum("nij,njk->nik", Bz, Rinv_M)
    C = jnp.einsum("nij,nkj->nik", Bz,
                   jnp.linalg.solve(stage.Quu, jnp.swapaxes(Bz, 1, 2)).swapaxes(1, 2))
    J = Qz - jnp.einsum("nji,njk->nik", Mz, Rinv_M)
    J = 0.5 * (J + jnp.swapaxes(J, 1, 2))
    return (F, C, J), (Az, Bz, Mz)


def _combine(a, b):
    """(phi_a o phi_b) — a is earlier in time, b later."""
    Fa, Ca, Ja = a
    Fb, Cb, Jb = b
    nz = Fa.shape[-1]
    eye = jnp.eye(nz, dtype=Fa.dtype)
    E = jnp.linalg.inv(eye + Ca @ Jb)
    F_ab = Fb @ E @ Fa
    C_ab = Cb + Fb @ E @ Ca @ jnp.swapaxes(Fb, -1, -2)
    J_ab = Ja + jnp.swapaxes(Fa, -1, -2) @ Jb @ E @ Fa
    C_ab = 0.5 * (C_ab + jnp.swapaxes(C_ab, -1, -2))
    J_ab = 0.5 * (J_ab + jnp.swapaxes(J_ab, -1, -2))
    return F_ab, C_ab, J_ab


def _inv_bl(A):
    """Unrolled Gauss-Jordan inverse of [n, n, E] (batch-minor), partial
    pivoting.  Keeps every op elementwise over the trailing element axis —
    the batch-minor shape (dense inv kernels on [E, n, n] leave the batch on a slow axis)."""
    n = A.shape[0]
    a = [[A[i, j] for j in range(n)] for i in range(n)]
    zeros = jnp.zeros_like(A[0, 0])
    ones = jnp.ones_like(A[0, 0])
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
    return jnp.stack([jnp.stack(row, axis=0) for row in inv], axis=0)


def _combine_bl(a, b):
    """Batch-minor combine: same algebra as :func:`_combine` with every
    contraction unrolled over the trailing element axis (see
    kernels/ddp_backward.py for why this layout matters)."""
    from nmpc_tpu.kernels.ddp_backward import _mm, _mT

    Fa, Ca, Ja = a
    Fb, Cb, Jb = b
    nz = Fa.shape[1]

    def bl(x):
        return jnp.moveaxis(x, 0, -1)   # [E, n, n] -> [n, n, E]

    def unbl(x):
        return jnp.moveaxis(x, -1, 0)

    Fa_, Ca_, Ja_ = bl(Fa), bl(Ca), bl(Ja)
    Fb_, Cb_, Jb_ = bl(Fb), bl(Cb), bl(Jb)
    eye = jnp.eye(nz, dtype=Fa.dtype)[:, :, None]
    E = _inv_bl(eye + _mm(Ca_, Jb_))
    FbE = _mm(Fb_, E)
    F_ab = _mm(FbE, Fa_)
    C_ab = Cb_ + _mm(_mm(FbE, Ca_), _mT(Fb_))
    J_ab = Ja_ + _mm(_mm(_mT(Fa_), _mm(Jb_, E)), Fa_)
    C_ab = 0.5 * (C_ab + _mT(C_ab))
    J_ab = 0.5 * (J_ab + _mT(J_ab))
    return unbl(F_ab), unbl(C_ab), unbl(J_ab)


def solve_lqr_parallel(stage: LQRStage, S_T, v_T=None):
    """All-stage value matrices and gains in O(log N) depth.

    S_T [nx, nx], v_T [nx] parametrize the terminal cost
    1/2 x'S_T x + v_T'x.  Returns (Ks [N, nu, nx], ks [N, nu],
    Ss [N+1, nz, nz] extended-state value matrices).
    """
    N, nx, nu = stage.B.shape
    nz = nx + 1
    dtype = stage.A.dtype
    if v_T is None:
        v_T = jnp.zeros((nx,), dtype)

    (F, C, J), (Az, Bz, Mz) = _extend(stage)

    # terminal element: constant flow S -> Sz_T
    Sz_T = jnp.zeros((nz, nz), dtype)
    Sz_T = Sz_T.at[:nx, :nx].set(S_T)
    Sz_T = Sz_T.at[:nx, nx].set(v_T)
    Sz_T = Sz_T.at[nx, :nx].set(v_T)
    F_all = jnp.concatenate([F, jnp.zeros((1, nz, nz), dtype)], axis=0)
    C_all = jnp.concatenate([C, jnp.zeros((1, nz, nz), dtype)], axis=0)
    J_all = jnp.concatenate([J, Sz_T[None]], axis=0)

    # suffix compositions: element i composed with everything after it.
    # NOTE: associative_scan(reverse=True) passes (later-combined, earlier)
    # to the operator, so flip the arguments.
    Fs, Cs, Js = lax.associative_scan(lambda a, b: _combine_bl(b, a),
                                      (F_all, C_all, J_all), reverse=True)
    Ss = Js  # phi_{i..T}(0): with S=0 the flow value is J  -> S_i
    # (the terminal element has F=0 so the trailing composition closes the
    # chain regardless of the seed)

    # stagewise gain recovery from S_{i+1}
    S_next = Ss[1:]                                     # [N, nz, nz]
    G = stage.Quu + jnp.einsum("nji,njk,nkl->nil", Bz, S_next, Bz)
    H = jnp.einsum("nji,njk,nkl->nil", Bz, S_next, Az) + Mz
    Kz = -jnp.linalg.solve(G, H)                        # [N, nu, nz]
    Ks = Kz[:, :, :nx]
    ks = Kz[:, :, nx]
    return Ks, ks, Ss


def solve_lqr_sequential(stage: LQRStage, S_T, v_T=None):
    """Classic backward recursion (reference shape, ``DDPSolver.hpp:367``);
    the O(N)-depth baseline the parallel version is tested against."""
    N, nx, nu = stage.B.shape
    dtype = stage.A.dtype
    if v_T is None:
        v_T = jnp.zeros((nx,), dtype)

    def step(carry, s):
        S, v = carry
        A, B, c, Qxx, Quu, Qux, q, r = s
        Gu = r + B.T @ (S @ c + v)
        G = Quu + B.T @ S @ B
        H = Qux + B.T @ S @ A
        K = -jnp.linalg.solve(G, H)
        k = -jnp.linalg.solve(G, Gu)
        S_new = Qxx + A.T @ S @ A + H.T @ K
        S_new = 0.5 * (S_new + S_new.T)
        v_new = (q + A.T @ (S @ c + v) + H.T @ k)
        return (S_new, v_new), (K, k)

    (_, _), (Ks, ks) = lax.scan(step, (S_T, v_T), tuple(stage), reverse=True)
    return Ks, ks
