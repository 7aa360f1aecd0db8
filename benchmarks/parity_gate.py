"""Kernel-versus-XLA parity gate, compiled on the GPU.

Every hand-written kernel has a plain XLA twin (the batch-minor stacked
backward, the ``lax.scan`` rollouts).  This gate runs both, compiled, at
the widths the solvers serve, and compares:

Kernel level (one call on first-iteration data):
  * ``ddp_backward``        — ``backward_pallas`` vs ``backward_stacked``
    (cart-pole, B=4096, N=100);
  * ``ddp_backward_boxed``  — ``backward_pallas_boxed`` vs
    ``backward_stacked_boxed`` (vertical motion, B=1024, N=100);
  * ``ddp_backward_remat``  — ``backward_remat`` vs the derivative sweep
    then ``backward_stacked`` (cart-pole, B=4096, N=100) or
    ``backward_stacked_boxed`` (vertical motion, B=1024, N=100);
  * ``ddp_forward``         — ``forward_selected_remat`` vs
    ``_forward_selected_lanes`` (cart-pole, B=4096, N=100);
  * ``fmpc_backward``       — ``backward_fmpc_pallas`` vs ``_backward_bm``
    (cart-pole serving shape N=100, ng=4, B=4096; oscillator B=1024);
  * ``fmpc_forward``        — ``forward_fmpc_deltas_pallas`` vs the scan.

End to end (full batched solves, default ``auto`` vs forced
stacked/scan): DDP cart-pole, boxed DDP vertical motion, FMPC cart-pole.

Tolerances: the kernels evaluate the same expressions on the same values
as their twins, but compiled XLA and Triton reassociate and contract fp32
arithmetic differently, so agreement is fp-noise level, not bit-exact (the
bit-exact contract is pinned by the interpreter tests in
tests/test_pallas_kernels.py).  Every matrix product runs at full fp32
precision (``jax.default_matmul_precision("highest")``), so TF32 does not
enter either side.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Normalized tolerances (max|a-b| / (1 + max|a|) per output): fp32
# reassociation over a 100-stage recursion stays orders below these; past
# them is a semantic divergence.
TOL_DDP_UNCONSTRAINED = 2e-4
TOL_DDP_BOXED = 2e-4
TOL_FMPC = 2e-4
# End-to-end contracts after a full iterated solve: statuses and per-lane
# iteration counts are EXACTLY equal; total costs agree to ~1e-6
# relative; u itself drifts in the iterated-fp32 chaos class on
# not-yet-converged lanes (accept decisions near a threshold amplify
# reassociation noise), so u is bounded by a normalized 1e-2 and cost by
# 1e-4; converged FMPC lanes by an absolute 2e-4.
TOL_E2E_DDP_U_NORM = 1e-2
TOL_E2E_DDP_COST_REL = 1e-4
TOL_E2E_FMPC_U = 2e-4


def _ddp_unconstrained_case(B=4096, N=100, with_trajectory=False):
    """First-iteration cart-pole derivative data at the headline shape.
    ``with_trajectory`` also returns ``(problem, t0, xs, us)``, batch-minor,
    the remat kernel's and the rollout's inputs."""
    from nmpc_tpu import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.solvers import ddp as Dmod
    from nmpc_tpu.kernels.ddp_backward import stack_derivs

    p = make_cartpole_problem(0.01)
    c = DDPConfig(horizon_steps=N, max_iter=10)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, N, 1)).astype(np.float32) * 0.2)
    t0 = jnp.float32(0.0)
    xs, _ = Dmod._rollout_stacked(p, c, t0, x0s, us)
    Ds, VxT, VxxT = jax.vmap(
        functools.partial(Dmod._derivative_sweep, p, c),
        in_axes=(None, 0, 0))(t0, xs, us)
    S = stack_derivs(Ds.Fx, Ds.Fu, Ds.Lx, Ds.Lu, Ds.Lxx, Ds.Luu, Ds.Lxu)
    lam = jnp.full((B,), 1e-4, jnp.float32)
    bm = lambda a: jnp.moveaxis(a, 0, -1)
    case = (c, S, bm(VxT), bm(VxxT), lam)
    if with_trajectory:
        case += (p, t0, bm(xs), bm(us))
    return case


def _ddp_boxed_case(B=1024, N=100, with_trajectory=False):
    """First-iteration vertical-motion boxed data, default BoxQP config.
    ``with_trajectory`` also returns ``(problem, t0, xs, us)``, batch-minor,
    the remat kernel's inputs."""
    from nmpc_tpu import DDPConfig
    from nmpc_tpu.models.vertical import make_vertical_problem
    from nmpc_tpu.solvers import ddp as Dmod
    from nmpc_tpu.kernels.ddp_backward import StackedBounds, StackedDerivs
    from nmpc_tpu.kernels.lanes import block_lanes, lane_factors

    p = make_vertical_problem(0.01)
    c = DDPConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                  with_input_constraint=True)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    us0 = jnp.asarray(0.02 * rng.normal(size=(B, N, 2)).astype(np.float32))
    t0 = jnp.float32(0.0)
    S, L = lane_factors(B)
    xs_l, _ = Dmod._rollout_lanes(p, c, t0, block_lanes(x0s, 0, S, L),
                                  block_lanes(us0, 0, S, L))
    D, VxT, VxxT = Dmod._derivative_sweep_lanes(
        p, c, t0, xs_l, block_lanes(us0, 0, S, L))
    flat = lambda a: a.reshape(a.shape[:-2] + (B,))
    Dst = StackedDerivs(Fx=flat(D.Fx), Fu=flat(D.Fu), Lx=flat(D.Lx),
                        Lu=flat(D.Lu), Lxx=flat(D.Lxx), Luu=flat(D.Luu),
                        Lxu=flat(D.Lxu))
    bounds = StackedBounds(lower=flat(D.lower), upper=flat(D.upper),
                           u=flat(D.u))
    lam = jnp.full((B,), 1e-6, jnp.float32)
    case = (c, Dst, bounds, flat(VxT), flat(VxxT), lam)
    if with_trajectory:
        case += (p, t0, flat(xs_l), flat(block_lanes(us0, 0, S, L)))
    return case


def _fmpc_case(problem, B, N):
    """First-iteration FMPC coefficients (batch-minor) for ``problem``."""
    from nmpc_tpu.core.types import FmpcConfig, fmpc_variable_reset
    from nmpc_tpu.solvers import fmpc as F

    p = problem
    c = FmpcConfig(horizon_steps=N, max_iter=5)
    nx, nu, ng = p.state_dim, p.input_dim, p.ineq_dim
    var1 = fmpc_variable_reset(N, nx, nu, ng, dtype=jnp.float32)
    vars_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), var1)
    eps0 = jnp.full((B,), 1e-4, jnp.float32)
    t0 = jnp.float32(0.0)
    bm = lambda a: jnp.moveaxis(a, 0, -1)
    var = jax.tree_util.tree_map(bm, vars_b)
    ts = t0 + p.dt * jnp.arange(N, dtype=jnp.float32)
    gms = jax.vmap(lambda t: p.ineq_mask_at(t).astype(jnp.float32))(ts)
    ineq_b = jax.vmap(p.ineq_const, in_axes=(None, -1, -1), out_axes=-1)
    g0 = jax.vmap(ineq_b)(ts, var.xs[:-1], var.us)
    ss = 1.01 * jnp.maximum(-g0, 1e-2)
    nus = 1.01 * jnp.maximum(eps0[None, None, :] / ss, 1e-2)
    var = type(var)(var.xs, var.us, var.lambdas, ss, nus)
    co = F._coeffs_bm(p, c, t0, var)
    return p, c, co, var, gms, eps0


def _norm_errs(o1, o2, names):
    """Per-output normalized error max|a-b| / (1 + max|a|) — scale-aware
    (dV sums over the horizon and is orders larger than ks)."""
    out = {}
    for i, n in enumerate(names):
        a = np.asarray(o1[i]).astype(np.float64)
        b = np.asarray(o2[i]).astype(np.float64)
        out[n] = float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(a))))
    return out


def _result(errs, tol, **extra):
    err = max(errs.values())
    ok = bool(err <= tol) and all(extra.values())
    return {"errs": errs, "max_err": err, "tol": tol, **extra, "pass": ok}


def _riccati_result(o1, o2, tol):
    ok_eq = bool((np.asarray(o1[3]) == np.asarray(o2[3])).all())
    return _result(_norm_errs(o1, o2, ("ks", "Ks", "dV")), tol,
                   ok_equal=ok_eq)


def check_ddp_backward(B=4096, N=100):
    from nmpc_tpu.kernels.ddp_backward import backward_stacked
    from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas

    c, S, VxT, VxxT, lam = _ddp_unconstrained_case(B, N)
    return _riccati_result(backward_stacked(c, S, VxT, VxxT, lam),
                           backward_pallas(c, S, VxT, VxxT, lam),
                           TOL_DDP_UNCONSTRAINED)


def check_ddp_backward_boxed(B=1024, N=100):
    from nmpc_tpu.kernels.ddp_backward import backward_stacked_boxed
    from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas_boxed

    c, Dst, bounds, VxT, VxxT, lam = _ddp_boxed_case(B, N)
    return _riccati_result(
        backward_stacked_boxed(c, Dst, bounds, VxT, VxxT, lam),
        backward_pallas_boxed(c, Dst, bounds, VxT, VxxT, lam),
        TOL_DDP_BOXED)


def check_ddp_backward_remat(boxed=False, B=None, N=100):
    """``backward_remat`` (stage derivatives recomputed in-kernel from the
    trajectory) against the derivative sweep followed by the stacked
    backward: cart-pole at B=4096, or boxed vertical motion at B=1024."""
    from nmpc_tpu.kernels.ddp_backward import (backward_stacked,
                                               backward_stacked_boxed)
    from nmpc_tpu.kernels.ddp_backward_remat import backward_remat

    if boxed:
        c, Dst, bounds, VxT, VxxT, lam, p, t0, xs, us = _ddp_boxed_case(
            B or 1024, N, with_trajectory=True)
        o1 = backward_stacked_boxed(c, Dst, bounds, VxT, VxxT, lam)
        return _riccati_result(
            o1, backward_remat(p, c, t0, xs, us, VxT, VxxT, lam, boxed=True),
            TOL_DDP_BOXED)
    c, S, VxT, VxxT, lam, p, t0, xs, us = _ddp_unconstrained_case(
        B or 4096, N, with_trajectory=True)
    return _riccati_result(
        backward_stacked(c, S, VxT, VxxT, lam),
        backward_remat(p, c, t0, xs, us, VxT, VxxT, lam),
        TOL_DDP_UNCONSTRAINED)


def check_ddp_forward(B=4096, N=100):
    """Selected-alpha rollout on the first-iteration backward's gains."""
    from nmpc_tpu.kernels.ddp_backward import backward_stacked
    from nmpc_tpu.kernels.ddp_forward_remat import forward_selected_remat
    from nmpc_tpu.kernels.lanes import block_lanes, lane_factors
    from nmpc_tpu.solvers import ddp as Dmod

    c, S, VxT, VxxT, lam, p, t0, xs_f, us_f = _ddp_unconstrained_case(
        B, N, with_trajectory=True)
    ks, Ks = backward_stacked(c, S, VxT, VxxT, lam)[:2]
    Sh, Lh = lane_factors(B)
    lb = lambda a: block_lanes(a, -1, Sh, Lh)
    alpha = jnp.full((B,), 0.5, jnp.float32)
    o1 = Dmod._forward_selected_lanes(p, c, t0, lb(xs_f), lb(us_f), lb(ks),
                                      lb(Ks), lb(alpha))
    o2 = forward_selected_remat(p, c, t0, xs_f, us_f, ks, Ks, alpha)
    flat = lambda a: jnp.asarray(a).reshape(a.shape[:-2] + (B,))
    return _result(_norm_errs([flat(a) for a in o1], o2,
                              ("xs", "us", "costs", "cost_sum")),
                   TOL_DDP_UNCONSTRAINED)


def check_fmpc_backward(problem, B, N):
    from nmpc_tpu.kernels.fmpc_backward_pallas import backward_fmpc_pallas
    from nmpc_tpu.solvers import fmpc as F

    p, c, co, var, gms, eps0 = _fmpc_case(problem, B, N)
    o1 = F._backward_bm(p, c, co, var.ss, var.nus, gms, eps0)
    o2 = backward_fmpc_pallas(p, c, co, var.ss, var.nus, gms, eps0)
    ok_eq = bool((np.asarray(o1[4]) == np.asarray(o2[4])).all())
    return _result(_norm_errs(o1, o2, ("ks", "Ks", "ss", "Ps")), TOL_FMPC,
                   ok_equal=ok_eq)


def check_fmpc_forward(B=4096, N=100):
    """Forward delta recursion on the first-iteration backward's gains."""
    from jax import lax
    from nmpc_tpu.kernels.ddp_backward import _mv
    from nmpc_tpu.kernels.fmpc_forward_pallas import (
        forward_fmpc_deltas_pallas)
    from nmpc_tpu.models.cartpole import make_cartpole_fmpc_problem
    from nmpc_tpu.solvers import fmpc as F

    p, c, co, var, gms, eps = _fmpc_case(make_cartpole_fmpc_problem(0.01),
                                         B, N)
    ks, Ks = F._backward_bm(p, c, co, var.ss, var.nus, gms, eps)[:2]
    dx0 = jnp.full_like(var.xs[0], 0.01)

    def fstep(dx, inp):
        A_, Bm_, x_bar, k, K = inp
        du = _mv(K, dx) + k
        return _mv(A_, dx) + _mv(Bm_, du) + x_bar, (dx, du)

    dxT, (dxs1, dus1) = jax.jit(lambda: lax.scan(
        fstep, dx0, (co.A, co.B, co.x_bar, ks, Ks)))()
    dxs1 = jnp.concatenate([dxs1, dxT[None]], axis=0)
    dxs2, dus2 = forward_fmpc_deltas_pallas(co.A, co.B, co.x_bar, ks, Ks,
                                            dx0)
    return _result(_norm_errs((dxs1, dus1), (dxs2, dus2), ("dxs", "dus")),
                   TOL_FMPC)


def kernel_checks() -> dict:
    """Every kernel against its XLA twin at the serving widths."""
    from nmpc_tpu.models.cartpole import make_cartpole_fmpc_problem
    from nmpc_tpu.models.oscillator import make_oscillator_problem

    with jax.default_matmul_precision("highest"):
        return {
            "ddp_backward": check_ddp_backward(),
            "ddp_backward_boxed": check_ddp_backward_boxed(),
            "ddp_backward_remat": check_ddp_backward_remat(),
            "ddp_backward_remat_boxed": check_ddp_backward_remat(boxed=True),
            "ddp_forward": check_ddp_forward(),
            "fmpc_backward": check_fmpc_backward(
                make_cartpole_fmpc_problem(0.01), B=4096, N=100),
            "fmpc_backward_oscillator": check_fmpc_backward(
                make_oscillator_problem(0.01), B=1024, N=100),
            "fmpc_forward": check_fmpc_forward(),
        }


# ---------------------------------------------------------------------------
# end-to-end cross-implementation checks
# ---------------------------------------------------------------------------


def _e2e_ddp_compare(a, b):
    """Cross-impl solve comparison: exact status/iters equality, tight
    cost agreement, u bounded in the normalized chaos class."""
    st_eq = bool(np.array_equal(np.asarray(a.status), np.asarray(b.status)))
    it_eq = bool(np.array_equal(np.asarray(a.iters), np.asarray(b.iters)))
    ua, ub = np.asarray(a.us, np.float64), np.asarray(b.us, np.float64)
    du = float(np.max(np.abs(ua - ub)) / (1.0 + np.max(np.abs(ua))))
    ca = np.asarray(jnp.sum(a.costs, axis=1), np.float64)
    cb = np.asarray(jnp.sum(b.costs, axis=1), np.float64)
    dc = float(np.max(np.abs(ca - cb) / (1.0 + np.abs(ca))))
    return {"status_equal": st_eq, "iters_equal": it_eq,
            "u_norm_diff": du, "u_tol": TOL_E2E_DDP_U_NORM,
            "cost_rel_diff": dc, "cost_tol": TOL_E2E_DDP_COST_REL,
            "pass": bool(st_eq and it_eq and du <= TOL_E2E_DDP_U_NORM
                         and dc <= TOL_E2E_DDP_COST_REL)}


def _e2e_ddp_unconstrained():
    """Full 10-iteration cart-pole solve_batch, default-auto vs stacked."""
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem

    p = make_cartpole_problem(0.01)
    B, N = 4096, 100
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us0 = jnp.zeros((B, N, 1), jnp.float32)
    t0 = jnp.float32(0.0)
    res = {}
    # "auto" = whatever the DEFAULT serves on this device — the e2e
    # contract follows the default so divergence-in-the-default cannot hide
    for impl, fwd in (("auto", "auto"), ("stacked", "scan")):
        c = DDPConfig(horizon_steps=N, max_iter=10, backward_impl=impl,
                      forward_impl=fwd)
        res[impl] = DDPSolver(p, c).solve_batch(t0, x0s, us0)
    return _e2e_ddp_compare(res["auto"], res["stacked"])


def _e2e_ddp_boxed():
    """Full 3-iteration boxed vertical-motion solve, default-auto vs
    stacked."""
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.vertical import make_vertical_problem

    p = make_vertical_problem(0.01)
    B, N = 1024, 100
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    us0 = jnp.asarray(0.02 * rng.normal(size=(B, N, 2)).astype(np.float32))
    t0 = jnp.float32(0.0)
    res = {}
    for impl, fwd in (("auto", "auto"), ("stacked", "scan")):
        c = DDPConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                      with_input_constraint=True, backward_impl=impl,
                      forward_impl=fwd)
        res[impl] = DDPSolver(p, c).solve_batch(t0, x0s, us0)
    return _e2e_ddp_compare(res["auto"], res["stacked"])


def _e2e_fmpc():
    """Full cart-pole FMPC solve at the serving shape, default ``auto``
    vs forced stacked/scan.  Contract: the converged-lane SET is
    identical and converged lanes agree tightly; diverging lanes are
    excluded (chaotic — see test_pallas_fmpc_solve_batch_end_to_end for
    the 1-ulp evidence)."""
    from nmpc_tpu.core.types import FmpcConfig, FmpcStatus, fmpc_variable_reset
    from nmpc_tpu.models.cartpole import make_cartpole_fmpc_problem
    from nmpc_tpu.solvers.fmpc import FmpcSolver

    p = make_cartpole_fmpc_problem(0.01)
    B, N = 4096, 100
    nx, nu, ng = p.state_dim, p.input_dim, p.ineq_dim
    rng = np.random.default_rng(0)
    # near-upright stabilization: the cold-start swing-up population never
    # reaches the KKT tolerance within any fixed budget (measured 0/512
    # SUCCEEDED at max_iter 20), so it cannot carry a converged-lane
    # contract; stabilization converges and drives the same pallas kernel
    x0s = jnp.asarray((0.15 * rng.normal(size=(B, 4))).astype(np.float32))
    var1 = fmpc_variable_reset(N, nx, nu, ng, dtype=jnp.float32)
    vars_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), var1)
    eps0 = jnp.full((B,), 1e-4, jnp.float32)
    t0 = jnp.float32(0.0)
    res = {}
    for impl, fwd in (("auto", "auto"), ("stacked", "scan")):
        # kkt_error_thre=1e-2: the fp32 KKT floor for this problem scale
        # is ~7e-3 (measured: the default 1e-4 is unreachable — 0/512
        # SUCCEEDED at any iteration budget; at 1e-2, 512/512 converge),
        # so this is the threshold at which the converged-lane contract
        # actually bites
        c = FmpcConfig(horizon_steps=N, max_iter=10, backward_impl=impl,
                       forward_impl=fwd, kkt_error_thre=1e-2,
                       init_complementary_variable=True)
        res[impl] = FmpcSolver(p, c).solve_batch(t0, x0s, vars_b, eps0)
    a, b = res["auto"], res["stacked"]
    st_a, st_b = np.asarray(a.status), np.asarray(b.status)
    conv_a = st_a == int(FmpcStatus.SUCCEEDED)
    conv_b = st_b == int(FmpcStatus.SUCCEEDED)
    set_eq = bool(np.array_equal(conv_a, conv_b))
    n_conv = int(conv_a.sum())
    if n_conv:
        du = float(np.max(np.abs(np.asarray(a.variable.us)[conv_a]
                                 - np.asarray(b.variable.us)[conv_a])))
    else:
        du = float("nan")
    # the contract must bite on a real population
    return {"converged_set_equal": set_eq, "n_converged": n_conv,
            "u_max_diff_converged": du, "tol": TOL_E2E_FMPC_U,
            "pass": bool(set_eq and n_conv >= B // 4
                         and du <= TOL_E2E_FMPC_U)}


def run_parity_gate() -> dict:
    """Kernel-level and end-to-end parity.  Returns ``{check: {...,
    pass}}`` plus an overall ``pass`` bool."""
    out = kernel_checks()
    out["e2e_ddp_unconstrained"] = _e2e_ddp_unconstrained()
    out["e2e_ddp_boxed"] = _e2e_ddp_boxed()
    out["e2e_fmpc"] = _e2e_fmpc()
    out["pass"] = all(v["pass"] for v in out.values()
                      if isinstance(v, dict))
    return out


if __name__ == "__main__":
    import json

    from nmpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    print(json.dumps(run_parity_gate(), indent=1))
