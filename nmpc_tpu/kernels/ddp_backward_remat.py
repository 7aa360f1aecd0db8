"""Pallas kernel (Triton route): whole-iteration fused DDP backward with
in-kernel derivative REMATERIALIZATION.

The sweep-fed backward (``ddp_backward_pallas.py``) reads the per-stage
derivative buffer (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu) that the vmapped
autodiff sweep writes.  This kernel removes that buffer: it reads only the
TRAJECTORY (x_i, u_i — nx + nu tiles per stage instead of
2nx² + 2nx·nu + nx + nu + nu² ≈ 46 at the cart-pole shape) and recomputes
each stage's derivatives from (x_i, u_i) as it walks the horizon, fusing
the reference's two hot loops — ``DDPSolver.hpp:160-178`` (derivative
sweep) and ``:343-534`` (backward recursion) — into one program with the
value-function carry in registers.

How the derivatives are computed in-kernel (kernels/tileval.py): the
problem's dynamics-jvp / cost-gradient / gradient-jvp functions are traced
ONCE at scalar shapes, dead-code-eliminated, and the jaxprs are
**interpreted on lane tiles** — every small-vector value becomes a flat
list of tiles, transposes/slices are free re-indexing, model constants
inline as python literals, and evaluating the jvp jaxprs with one-hot
LITERAL seeds constant-folds into exactly the analytic partial-derivative
expressions.

Semantics contract: the same derivative math as
``_derivative_sweep_lanes`` (jvp columns of the same callables on the
same (t_i, x_i, u_i) values; ``t_i = t0 + dt * i`` uses the same fp32
ops as the sweep's ``t0 + dt * arange(N)``), followed by the same
unrolled tile Riccati stage as ``backward_pallas`` (boxed: including the
in-kernel BoxQP).

Eligibility (:func:`remat_supported`): fp32, ``deriv_dtype == "same"``,
first-order only, and problem callbacks whose traces the tile interpreter
supports (plain jnp algebra; no gathers/scans/big tables).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax._src.interpreters.partial_eval import dce_jaxpr_consts
from jax.extend.core import ClosedJaxpr

from nmpc_tpu.core.types import DDPConfig
from nmpc_tpu.kernels.ddp_backward_pallas import (riccati_loop,
                                                  riccati_out_shapes)
from nmpc_tpu.kernels.lane_kernel import lane_call
from nmpc_tpu.kernels.tileval import (TileVal, _Ctx, eval_jaxpr_tiles,
                                      jaxpr_tile_supported)


@functools.lru_cache(maxsize=256)
def _hoist(problem, which: str, nx: int, nu: int, dtype_name: str):
    """Trace one scalar stage callable, DCE it, and package it for the
    tile interpreter: returns (closed_jaxpr, used_args, out_tree,
    n_eqns).  ``used_args`` marks which of the declared scalar inputs
    survived DCE (the interpreter is fed only those)."""
    dtype = jnp.dtype(dtype_name)
    sd = jax.ShapeDtypeStruct

    t_av, x_av, u_av = sd((), dtype), sd((nx,), dtype), sd((nu,), dtype)
    if which == "dyn_jvp":
        def f(t, x, u, dx, du):
            _, tang = jax.jvp(lambda xx, uu: problem.dynamics(t, xx, uu),
                              (x, u), (dx, du))
            return tang
        avals = (t_av, x_av, u_av, x_av, u_av)
    elif which == "dyn_derivs":
        f = problem.dynamics_derivs
        avals = (t_av, x_av, u_av)
    elif which == "cost_grad":
        def f(t, x, u):
            return (jax.grad(problem.running_cost, argnums=1)(t, x, u),
                    jax.grad(problem.running_cost, argnums=2)(t, x, u))
        avals = (t_av, x_av, u_av)
    elif which == "cost_grad_jvp":
        def f(t, x, u, dx, du):
            def g(xx, uu):
                return (jax.grad(problem.running_cost, argnums=1)(t, xx, uu),
                        jax.grad(problem.running_cost, argnums=2)(t, xx, uu))
            _, tang = jax.jvp(g, (x, u), (dx, du))
            return tang
        avals = (t_av, x_av, u_av, x_av, u_av)
    elif which == "cost_derivs":
        f = problem.running_cost_derivs
        avals = (t_av, x_av, u_av)
    elif which == "dyn":
        f = problem.dynamics
        avals = (t_av, x_av, u_av)
    elif which == "cost":
        f = problem.running_cost
        avals = (t_av, x_av, u_av)
    elif which == "term":
        f = problem.terminal_cost
        avals = (t_av, x_av)
    elif which == "aux":
        # mask + box bounds, mirrors solvers/ddp.py::_stage_derivs
        def f(t, x, u):
            mask = problem.input_mask_at(t).astype(x.dtype)
            if problem.input_limits is not None:
                lower, upper = problem.input_limits(t)
                lower = jnp.asarray(lower, x.dtype)
                upper = jnp.asarray(upper, x.dtype)
                if problem.input_mask is not None:
                    lower = jnp.where(mask > 0, lower,
                                      -jnp.ones_like(lower))
                    upper = jnp.where(mask > 0, upper, jnp.ones_like(upper))
            else:
                lower = jnp.full((nu,), -jnp.inf, x.dtype)
                upper = jnp.full((nu,), jnp.inf, x.dtype)
            return mask, lower, upper
        avals = (t_av, x_av, u_av)
    else:  # pragma: no cover
        raise ValueError(which)

    closed = jax.make_jaxpr(f)(*avals)
    tree = jax.tree_util.tree_structure(jax.eval_shape(f, *avals))
    # DCE before in-kernel interpretation: autodiff traces record large
    # dead primal computations (the raw cost-gradient-jvp trace is ~3x
    # its live size)
    new_jaxpr, used_c, used_args = dce_jaxpr_consts(
        closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    consts = [c for c, u_ in zip(closed.consts, used_c) if u_]
    closed = ClosedJaxpr(new_jaxpr, consts)
    return closed, tuple(used_args), tree, len(closed.jaxpr.eqns)


def _hoist_groups(problem, nx: int, nu: int, boxed: bool, dtype_name: str):
    groups = {}
    if problem.dynamics_derivs is not None:
        groups["dyn_derivs"] = _hoist(problem, "dyn_derivs", nx, nu,
                                      dtype_name)
    else:
        groups["dyn_jvp"] = _hoist(problem, "dyn_jvp", nx, nu, dtype_name)
    if problem.running_cost_derivs is not None:
        groups["cost_derivs"] = _hoist(problem, "cost_derivs", nx, nu,
                                       dtype_name)
    else:
        groups["cost_grad"] = _hoist(problem, "cost_grad", nx, nu,
                                     dtype_name)
        groups["cost_grad_jvp"] = _hoist(problem, "cost_grad_jvp", nx, nu,
                                         dtype_name)
    if problem.input_mask is not None or boxed:
        groups["aux"] = _hoist(problem, "aux", nx, nu, dtype_name)
    return groups


def remat_supported(problem, nx: int, nu: int, boxed: bool,
                    dtype_name: str = "float32") -> bool:
    """Static gate for the solver's ``auto`` rule: True iff every stage
    callable's (DCE'd) trace can be tile-interpreted in-kernel."""
    try:
        groups = _hoist_groups(problem, nx, nu, boxed, dtype_name)
    except Exception:  # noqa: BLE001 — untraceable callables
        return False
    return all(jaxpr_tile_supported(g[0]) for g in groups.values())


def _tile_call(group, args, ctx):
    closed, used_args, tree, _ = group
    kept = [a for a, u_ in zip(args, used_args) if u_]
    out = eval_jaxpr_tiles(closed, kept, ctx)
    return jax.tree_util.tree_unflatten(tree, out)


def _stage_fields_tile(problem, groups, ctx, t, x, u, nx: int, nu: int,
                       boxed: bool, dtype):
    """Rematerialize one stage's Riccati fields from tile LISTS
    x (nx tiles), u (nu tiles) via the tile interpreter.  Field entries
    may be python literals (folded constants) — downstream jnp arithmetic
    broadcasts them and the compiler constant-folds."""
    tv = lambda shape, elems: TileVal(shape, dtype, elems)
    t_v = tv((), [t])
    x_v = tv((nx,), x)
    u_v = tv((nu,), u)

    def onehot(dim, c):
        return tv((dim,), [1.0 if a == c else 0.0 for a in range(dim)])

    zx, zu = tv((nx,), [0.0] * nx), tv((nu,), [0.0] * nu)

    # ---- dynamics first derivatives ------------------------------------
    if "dyn_derivs" in groups:
        FxV, FuV = _tile_call(groups["dyn_derivs"], (t_v, x_v, u_v), ctx)
        Fx = [[FxV.at((r, c)) for c in range(nx)] for r in range(nx)]
        Fu = [[FuV.at((r, c)) for c in range(nu)] for r in range(nx)]
    else:
        g = groups["dyn_jvp"]
        Fx = [[None] * nx for _ in range(nx)]
        Fu = [[None] * nu for _ in range(nx)]
        for c in range(nx):
            col = _tile_call(g, (t_v, x_v, u_v, onehot(nx, c), zu), ctx)
            for r in range(nx):
                Fx[r][c] = col.elems[r]
        for c in range(nu):
            col = _tile_call(g, (t_v, x_v, u_v, zx, onehot(nu, c)), ctx)
            for r in range(nx):
                Fu[r][c] = col.elems[r]

    # ---- running-cost expansion ----------------------------------------
    if "cost_derivs" in groups:
        LxV, LuV, LxxV, LuuV, LxuV = _tile_call(
            groups["cost_derivs"], (t_v, x_v, u_v), ctx)
        Lx = [LxV.elems[a] for a in range(nx)]
        Lu = [LuV.elems[a] for a in range(nu)]
        Lxx = [[LxxV.at((r, c)) for c in range(nx)] for r in range(nx)]
        Luu = [[LuuV.at((r, c)) for c in range(nu)] for r in range(nu)]
        Lxu = [[LxuV.at((r, c)) for c in range(nu)] for r in range(nx)]
    else:
        LxV, LuV = _tile_call(groups["cost_grad"], (t_v, x_v, u_v), ctx)
        Lx = [LxV.elems[a] for a in range(nx)]
        Lu = [LuV.elems[a] for a in range(nu)]
        gj = groups["cost_grad_jvp"]
        Lxx = [[None] * nx for _ in range(nx)]
        Luu = [[None] * nu for _ in range(nu)]
        Lxu = [[None] * nu for _ in range(nx)]
        for c in range(nx):
            gx, gu = _tile_call(gj, (t_v, x_v, u_v, onehot(nx, c), zu), ctx)
            for r in range(nx):
                Lxx[r][c] = gx.elems[r]
            for r in range(nu):
                Lxu[c][r] = gu.elems[r]   # d2l / dx_c du_r
        for c in range(nu):
            gx, gu = _tile_call(gj, (t_v, x_v, u_v, zx, onehot(nu, c)), ctx)
            for r in range(nu):
                Luu[r][c] = gu.elems[r]

    fields = {"Fx": Fx, "Fu": Fu, "Lx": Lx, "Lu": Lu,
              "Lxx": Lxx, "Luu": Luu, "Lxu": Lxu}

    # ---- mask + bounds (mirror of _stage_derivs) -----------------------
    if "aux" in groups:
        maskV, lowerV, upperV = _tile_call(groups["aux"], (t_v, x_v, u_v),
                                           ctx)
        m = [maskV.elems[a] for a in range(nu)]
        if problem.input_mask is not None:
            fields["Fu"] = [[Fu[r][c] * m[c] for c in range(nu)]
                            for r in range(nx)]
            fields["Lu"] = [Lu[c] * m[c] for c in range(nu)]
            fields["Luu"] = [[Luu[r][c] * m[r] * m[c]
                              + ((1.0 - m[r]) if r == c else 0.0)
                              for c in range(nu)] for r in range(nu)]
            fields["Lxu"] = [[Lxu[r][c] * m[c] for c in range(nu)]
                             for r in range(nx)]
        if boxed:
            fields["lower"] = [lowerV.elems[a] for a in range(nu)]
            fields["upper"] = [upperV.elems[a] for a in range(nu)]
            fields["u"] = list(u)
    elif boxed:  # pragma: no cover — boxed without limits is degenerate
        fields["lower"] = [-jnp.inf] * nu
        fields["upper"] = [jnp.inf] * nu
        fields["u"] = list(u)

    # literal field entries are fine for the Riccati algebra (python
    # floats broadcast); promote them to f32 scalars only where masked
    # arithmetic above could have produced exact python ints
    return fields


def backward_remat(problem, config: DDPConfig, t0, xs, us, Vx_T, Vxx_T,
                   lam, boxed: bool = False):
    """Drop-in for ``backward_stacked`` / ``backward_stacked_boxed`` that
    takes the TRAJECTORY instead of precomputed stage derivatives.

    Args (batch-minor, trailing axis B): xs [N+1, nx, B], us [N, nu, B],
    Vx_T [nx, B], Vxx_T [nx, nx, B], lam [B]; t0 scalar.
    Returns (ks [N, nu, B], Ks [N, nu, nx, B], dV [2, B], ok [B]).

    ``boxed=True`` runs the in-kernel BoxQP with the per-stage bounds
    rematerialized from ``problem.input_limits``.
    """
    N = us.shape[0]
    nx = xs.shape[1]
    nu = us.shape[1]
    B = lam.shape[-1]
    dtype = xs.dtype
    groups = _hoist_groups(problem, nx, nu, boxed, jnp.dtype(dtype).name)
    dt = float(problem.dt)

    def kernel(xs_ref, us_ref, t0_ref, VxT_ref, VxxT_ref, lam_ref, *outs):
        t0_t = t0_ref[...]
        ctx = _Ctx()   # shared CSE memo: primals unify across jvp columns

        def stage_fields(i):
            # same fp32 ops as the sweep's t0 + dt * arange(N)
            t_i = t0_t + jnp.float32(dt) * i.astype(jnp.float32)
            x_t = [xs_ref[i, a] for a in range(nx)]
            u_t = [us_ref[i, a] for a in range(nu)]
            return _stage_fields_tile(problem, groups, ctx, t_i, x_t, u_t,
                                      nx, nu, boxed, dtype)

        riccati_loop(config, nx, nu, N, boxed, stage_fields,
                     VxT_ref, VxxT_ref, lam_ref, *outs)

    t0_b = jnp.full((B,), t0, dtype)
    ks, Ks, dV, okf = lane_call(
        kernel, name="ddp_backward_remat",
        inputs=[xs, us, t0_b, Vx_T, Vxx_T, lam],
        out_shapes=riccati_out_shapes(nx, nu, N, dtype))
    return ks, Ks, dV, okf > 0.5
