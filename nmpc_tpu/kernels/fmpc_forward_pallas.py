"""Pallas kernel (Triton route): fused FMPC forward recursion (delta rollout).

The FMPC iteration's forward recursion (``FmpcSolver.hpp:668-708``,
``solvers/fmpc.py::_forward_bm``) is a LINEAR stage recursion
``du = K dx + k; dx' = A dx + B du + x_bar`` — as a ``lax.scan`` it pays N
loop trips of a handful of small mat-vecs.  This kernel runs it in one
program per lane block: the per-stage coefficients (A, B, x_bar, k, K) are
loaded from device memory while the carry ``dx`` stays in registers.  The
recursion is linear in precomputed coefficients, so the kernel is pure
tile algebra (no tile interpretation).

The Δλ/Δs/Δν post-passes stay at the XLA level (elementwise over the big
Ps/C/D buffers — XLA fuses them into single passes; nothing sequential to
win there).

Semantics contract (pinned by tests/test_pallas_kernels.py in interpreter
mode): identical expressions on identical values as ``_forward_bm``'s scan
— ``dxs[i]`` is the PRE-step delta, ``dxs[N]`` the final carry; mat-vec
reductions accumulate over the contracted dim in index order.
"""

from __future__ import annotations

from jax import lax

from nmpc_tpu.kernels.lane_kernel import lane_call


def forward_fmpc_deltas_pallas(A, Bm, xb, ks, Ks, dx0):
    """Fused (dxs, dus) recursion on batch-minor arrays:
    A [N, nx, nx, B], Bm [N, nx, nu, B], xb [N, nx, B], ks [N, nu, B],
    Ks [N, nu, nx, B], dx0 [nx, B] -> (dxs [N+1, nx, B], dus [N, nu, B])."""
    N, nx = A.shape[0], A.shape[1]
    nu = Bm.shape[2]
    dtype = dx0.dtype

    def kernel(A_ref, B_ref, xb_ref, ks_ref, Ks_ref, dx0_ref,
               dxs_ref, dus_ref):
        def body(j, dx):
            # du = K dx + k  (reduction over nx in index order, matching
            # _mv's jnp.sum over the contracted axis)
            du = []
            for a in range(nu):
                acc = None
                for b in range(nx):
                    t = Ks_ref[j, a, b] * dx[b]
                    acc = t if acc is None else acc + t
                du.append(acc + ks_ref[j, a])
            # dx' = A dx + B du + x_bar
            dxn = []
            for r in range(nx):
                acc = None
                for b in range(nx):
                    t = A_ref[j, r, b] * dx[b]
                    acc = t if acc is None else acc + t
                for a in range(nu):
                    acc = acc + B_ref[j, r, a] * du[a]
                dxn.append(acc + xb_ref[j, r])
            for b in range(nx):
                dxs_ref[j, b] = dx[b]
            for a in range(nu):
                dus_ref[j, a] = du[a]
            return dxn

        dxT = lax.fori_loop(0, N, body, [dx0_ref[b] for b in range(nx)])
        for b in range(nx):
            dxs_ref[N, b] = dxT[b]

    dxs, dus = lane_call(
        kernel, name="fmpc_forward",
        inputs=[A, Bm, xb, ks, Ks, dx0],
        out_shapes=[((N + 1, nx), dtype), ((N, nu), dtype)])
    return dxs, dus
