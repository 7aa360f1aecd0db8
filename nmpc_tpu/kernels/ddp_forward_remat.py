"""Pallas kernel (Triton route): fused DDP selected-alpha rollout.

The line search's accepted-trajectory rollout
(``solvers/ddp.py::_forward_selected_lanes``; reference serial rollout
``DDPSolver.hpp:537-560``) is serial per lane: as a ``lax.scan`` it pays N
loop trips of tiny ops.  This kernel runs the whole rollout in one program
per lane block: per-stage (x_ref, u_ref, k, K) are loaded from device
memory while the candidate state and the cost accumulator stay in
registers, and the problem's dynamics / running-cost / terminal-cost
callables are evaluated by the jaxpr tile interpreter
(``kernels/tileval.py``).

Semantics contract (vs the scan path, pinned by
tests/test_pallas_kernels.py in interpreter mode and by
benchmarks/parity_gate.py on the card): ``u = u_ref + alpha * k + K dx``
with ``dx`` accumulated left-to-right over nx, ``x' = dynamics(t_i, x,
u)``, cost accumulated in horizon order then terminal — the same
expressions on the same values; agreement is fp-reassociation-level.
``t_i`` uses the scan's ``t0 + dt * i`` fp32 ops.

Eligibility (:func:`forward_remat_supported`): cost sums at the solve
dtype and tile-interpretable dynamics / running-cost / terminal-cost
traces.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from nmpc_tpu.core.types import DDPConfig
from nmpc_tpu.kernels.ddp_backward_remat import _hoist, _tile_call
from nmpc_tpu.kernels.lane_kernel import lane_call
from nmpc_tpu.kernels.tileval import TileVal, _Ctx, _is_lit, jaxpr_tile_supported


def _hoist_forward_groups(problem, nx: int, nu: int, dtype_name: str):
    return {
        "dyn": _hoist(problem, "dyn", nx, nu, dtype_name),
        "cost": _hoist(problem, "cost", nx, nu, dtype_name),
        "term": _hoist(problem, "term", nx, nu, dtype_name),
    }


def forward_remat_supported(problem, nx: int, nu: int,
                            dtype_name: str = "float32") -> bool:
    """Static gate for the solver's ``auto`` rule: True iff the rollout
    callables' (DCE'd) traces can be tile-interpreted in-kernel."""
    try:
        groups = _hoist_forward_groups(problem, nx, nu, dtype_name)
    except Exception:  # noqa: BLE001 — untraceable callables
        return False
    return all(jaxpr_tile_supported(g[0]) for g in groups.values())


def _astile(v, like):
    """Tile-interpreter outputs may be folded python literals; promote to
    a full tile before a ref store / fp accumulate with traced values."""
    if _is_lit(v):
        return jnp.full(like.shape, v, like.dtype)
    return v


def _stage_forward(groups, ctx, t_i, x, xr, ur, kv, Kv, alpha, nx, nu,
                   dtype):
    """One line-search forward stage on lane tiles: the scan body of
    ``_forward_selected_lanes`` (dx feedback, dynamics step, stage cost)
    with a per-lane ``alpha`` tile."""
    dx = [x[b] - xr[b] for b in range(nx)]
    u = []
    for a in range(nu):
        acc = ur[a] + alpha * kv[a]
        for b in range(nx):
            acc = acc + Kv[a][b] * dx[b]
        u.append(acc)
    t_v = TileVal((), dtype, [t_i])
    x_v = TileVal((nx,), dtype, list(x))
    u_v = TileVal((nu,), dtype, list(u))
    xn_v = _tile_call(groups["dyn"], (t_v, x_v, u_v), ctx)
    c_v = _tile_call(groups["cost"], (t_v, x_v, u_v), ctx)
    xn = [_astile(xn_v.elems[b], x[0]) for b in range(nx)]
    c = _astile(c_v.elems[0], x[0])
    return xn, u, c


def forward_selected_remat(problem, config: DDPConfig, t0, xs, us, ks, Ks,
                           alpha):
    """Drop-in for ``_forward_selected_lanes`` on flat-B batch-minor
    arrays: xs [N+1, nx, B], us/ks [N, nu, B], Ks [N, nu, nx, B],
    alpha [B] (per-lane).  Returns (xs_new [N+1, nx, B], us_new
    [N, nu, B], costs [N+1, B], cost_sum [B]); the sum is accumulated in
    horizon order exactly like the scan path (the line search's
    accept-decision contract)."""
    del config
    N = us.shape[0]
    nx = xs.shape[1]
    nu = us.shape[1]
    B = alpha.shape[-1]
    dtype = xs.dtype
    groups = _hoist_forward_groups(problem, nx, nu, jnp.dtype(dtype).name)
    dt = float(problem.dt)

    def kernel(xs_ref, us_ref, ks_ref, Ks_ref, alpha_ref, t0_ref,
               xsn_ref, usn_ref, costs_ref, csum_ref):
        alpha = alpha_ref[...]
        t0_t = t0_ref[...]
        ctx = _Ctx()
        x0 = [xs_ref[0, b] for b in range(nx)]
        for b in range(nx):
            xsn_ref[0, b] = x0[b]

        def body(j, carry):
            x, ctot = carry
            xr = [xs_ref[j, b] for b in range(nx)]
            ur = [us_ref[j, a] for a in range(nu)]
            kv = [ks_ref[j, a] for a in range(nu)]
            Kv = [[Ks_ref[j, a, b] for b in range(nx)] for a in range(nu)]
            # same fp32 ops as the scan's t0 + dt * arange(N)
            t_i = t0_t + jnp.float32(dt) * j.astype(jnp.float32)
            xn, u, c = _stage_forward(groups, ctx, t_i, x, xr, ur, kv, Kv,
                                      alpha, nx, nu, dtype)
            for b in range(nx):
                xsn_ref[j + 1, b] = xn[b]
            for a in range(nu):
                usn_ref[j, a] = u[a]
            costs_ref[j] = c
            return (xn, ctot + c)

        xN, ctot = lax.fori_loop(0, N, body, (x0, jnp.zeros_like(alpha)))
        tN = t0_t + jnp.float32(N * dt)
        cT_v = _tile_call(groups["term"], (TileVal((), dtype, [tN]),
                                           TileVal((nx,), dtype, list(xN))),
                          ctx)
        cT = _astile(cT_v.elems[0], alpha)
        costs_ref[N] = cT
        csum_ref[...] = ctot + cT

    return tuple(lane_call(
        kernel, name="ddp_forward_selected",
        inputs=[xs, us, ks, Ks, alpha, jnp.full((B,), t0, dtype)],
        out_shapes=[((N + 1, nx), dtype), ((N, nu), dtype),
                    ((N + 1,), dtype), ((), dtype)]))
