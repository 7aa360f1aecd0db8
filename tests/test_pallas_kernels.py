"""Pallas kernel parity tests: the Triton-route lane kernels run in the
Pallas interpreter on the CPU.  The compiled kernels are checked against
the same references on the GPU by ``benchmarks/parity_gate.py`` (run by
``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmpc_tpu.kernels import lane_kernel


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(lane_kernel, "INTERPRET", True)


def test_pallas_backward_matches_stacked(interpret_pallas):
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.solvers import ddp as D
    from nmpc_tpu.kernels.ddp_backward import backward_stacked, stack_derivs
    import nmpc_tpu.kernels.ddp_backward_pallas as P

    p = make_cartpole_problem(0.01)
    c = DDPConfig(horizon_steps=12, max_iter=10)
    B = 256
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, 12, 1)).astype(np.float32) * 0.2)
    xs, _ = D._rollout_stacked(p, c, 0.0, x0s, us)
    Ds, VxT, VxxT = jax.vmap(
        functools.partial(D._derivative_sweep, p, c),
        in_axes=(None, 0, 0))(0.0, xs, us)
    S = stack_derivs(Ds.Fx, Ds.Fu, Ds.Lx, Ds.Lu, Ds.Lxx, Ds.Luu, Ds.Lxu)
    VxTs = jnp.moveaxis(VxT, 0, -1)
    VxxTs = jnp.moveaxis(VxxT, 0, -1)
    lam = jnp.full((B,), 1e-4, jnp.float32)

    o1 = backward_stacked(c, S, VxTs, VxxTs, lam)
    o2 = P.backward_pallas(c, S, VxTs, VxxTs, lam)
    np.testing.assert_allclose(np.asarray(o2[0]), np.asarray(o1[0]),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(o2[1]), np.asarray(o1[1]),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(o2[2]), np.asarray(o1[2]),
                               atol=2e-4)
    assert bool(jnp.all(o1[3] == o2[3]))


def test_remat_backward_matches_stacked(interpret_pallas):
    """Whole-iteration fused backward with in-kernel derivative
    rematerialization (kernels/ddp_backward_remat.py) vs the sweep +
    stacked backward: the remat kernel re-traces ``_stage_derivs`` on
    (BLOCK,) lane tiles from (x_i, u_i), so its derivatives are the
    same autodiff expressions evaluated on the same inputs — agreement is
    fp-reassociation-level."""
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.solvers import ddp as D
    from nmpc_tpu.kernels.ddp_backward import backward_stacked, stack_derivs
    from nmpc_tpu.kernels.ddp_backward_remat import backward_remat

    p = make_cartpole_problem(0.01)
    c = DDPConfig(horizon_steps=12, max_iter=10)
    B = 256
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, 12, 1)).astype(np.float32) * 0.2)
    t0 = jnp.float32(0.3)   # nonzero so the in-kernel t_i recompute bites
    xs, _ = D._rollout_stacked(p, c, t0, x0s, us)
    Ds, VxT, VxxT = jax.vmap(
        functools.partial(D._derivative_sweep, p, c),
        in_axes=(None, 0, 0))(t0, xs, us)
    S = stack_derivs(Ds.Fx, Ds.Fu, Ds.Lx, Ds.Lu, Ds.Lxx, Ds.Luu, Ds.Lxu)
    VxTs = jnp.moveaxis(VxT, 0, -1)
    VxxTs = jnp.moveaxis(VxxT, 0, -1)
    lam = jnp.full((B,), 1e-4, jnp.float32)

    o1 = backward_stacked(c, S, VxTs, VxxTs, lam)
    o2 = backward_remat(p, c, t0, jnp.moveaxis(xs, 0, -1),
                        jnp.moveaxis(us, 0, -1), VxTs, VxxTs, lam)
    np.testing.assert_allclose(np.asarray(o2[0]), np.asarray(o1[0]),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(o2[1]), np.asarray(o1[1]),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(o2[2]), np.asarray(o1[2]),
                               atol=2e-4)
    assert bool(jnp.all(o1[3] == o2[3]))


def test_remat_backward_boxed_matches_stacked(interpret_pallas):
    """Boxed remat: bounds + BoxQP inputs rematerialized in-kernel from
    ``problem.input_limits`` / the streamed u_i, vs the sweep + stacked
    boxed backward (time-varying input dims exercised via the vertical
    model's mask)."""
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.vertical import make_vertical_problem
    from nmpc_tpu.solvers import ddp as D
    from nmpc_tpu.kernels.ddp_backward import (StackedBounds, StackedDerivs,
                                               backward_stacked_boxed)
    from nmpc_tpu.kernels.ddp_backward_remat import backward_remat
    from nmpc_tpu.kernels.lanes import block_lanes, lane_factors

    p = make_vertical_problem(0.01)
    c = DDPConfig(horizon_steps=12, max_iter=3, initial_lambda=1e-6,
                  with_input_constraint=True)
    B = 128
    rng = np.random.default_rng(1)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    us0 = jnp.asarray(0.02 * rng.normal(size=(B, 12, 2)).astype(np.float32))
    t0 = jnp.float32(0.0)
    S_, L_ = lane_factors(B)
    xs_l, _ = D._rollout_lanes(p, c, t0, block_lanes(x0s, 0, S_, L_),
                               block_lanes(us0, 0, S_, L_))
    us_l = block_lanes(us0, 0, S_, L_)
    Dv, VxT, VxxT = D._derivative_sweep_lanes(p, c, t0, xs_l, us_l)
    flat = lambda a: a.reshape(a.shape[:-2] + (B,))
    Dst = StackedDerivs(Fx=flat(Dv.Fx), Fu=flat(Dv.Fu), Lx=flat(Dv.Lx),
                        Lu=flat(Dv.Lu), Lxx=flat(Dv.Lxx), Luu=flat(Dv.Luu),
                        Lxu=flat(Dv.Lxu))
    bounds = StackedBounds(lower=flat(Dv.lower), upper=flat(Dv.upper),
                           u=flat(Dv.u))
    lam = jnp.full((B,), 1e-6, jnp.float32)

    o1 = backward_stacked_boxed(c, Dst, bounds, flat(VxT), flat(VxxT), lam)
    o2 = backward_remat(p, c, t0, flat(xs_l), flat(us_l),
                        flat(VxT), flat(VxxT), lam, boxed=True)
    np.testing.assert_allclose(np.asarray(o2[0]), np.asarray(o1[0]),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(o2[1]), np.asarray(o1[1]),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(o2[2]), np.asarray(o1[2]),
                               atol=2e-4)
    assert bool(jnp.all(o1[3] == o2[3]))


def _boxed_backward_case():
    """First-iteration stacked derivative data for the vertical-motion
    boxed config (time-varying input dims + control limits), the same
    construction as benchmarks/profile_boxed_ddp.py."""
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.vertical import make_vertical_problem
    from nmpc_tpu.solvers import ddp as Dmod
    from nmpc_tpu.kernels.ddp_backward import StackedBounds, StackedDerivs
    from nmpc_tpu.kernels.lanes import block_lanes, lane_factors

    from nmpc_tpu.core.types import BoxQPConfig

    problem = make_vertical_problem(0.01)
    N, B = 20, 128
    # max_ls_iter=16 keeps the interpreter tractable (the kernel unrolls
    # the full schedule); both paths share the schedule, so parity is
    # pinned on the same semantics — full-width parity is checked compiled
    # on the GPU by benchmarks/parity_gate.py
    config = DDPConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                       with_input_constraint=True,
                       boxqp=BoxQPConfig(max_ls_iter=16))
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    us0 = jnp.asarray(
        0.02 * rng.normal(size=(B, N, 2)).astype(np.float32))
    t0 = jnp.float32(0.0)
    S, L = lane_factors(B)
    xs_l, _ = Dmod._rollout_lanes(problem, config, t0,
                                  block_lanes(x0s, 0, S, L),
                                  block_lanes(us0, 0, S, L))
    D, VxT, VxxT = Dmod._derivative_sweep_lanes(
        problem, config, t0, xs_l, block_lanes(us0, 0, S, L))
    flat = lambda a: a.reshape(a.shape[:-2] + (B,))
    Dst = StackedDerivs(Fx=flat(D.Fx), Fu=flat(D.Fu), Lx=flat(D.Lx),
                        Lu=flat(D.Lu), Lxx=flat(D.Lxx), Luu=flat(D.Luu),
                        Lxu=flat(D.Lxu))
    bounds = StackedBounds(lower=flat(D.lower), upper=flat(D.upper),
                           u=flat(D.u))
    lam = jnp.full((B,), 1e-6, jnp.float32)
    return config, Dst, bounds, flat(VxT), flat(VxxT), lam


def test_pallas_boxed_backward_matches_stacked(interpret_pallas):
    """Fused boxed kernel (in-kernel BoxQP) vs the stacked boxed kernel on
    real vertical-motion derivative data — active control limits, masked
    input dims, QP warm starts.  The parity contract is exact agreement
    when QP trips <= unroll_iter and accepts land in the Armijo head
    (measured true for the boxed model configs)."""
    from nmpc_tpu.kernels.ddp_backward import backward_stacked_boxed
    from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas_boxed

    config, Dst, bounds, VxT_f, VxxT_f, lam = _boxed_backward_case()
    o1 = backward_stacked_boxed(config, Dst, bounds, VxT_f, VxxT_f, lam)
    o2 = backward_pallas_boxed(config, Dst, bounds, VxT_f, VxxT_f, lam)
    for name, a, b in zip(("ks", "Ks", "dV"), o1[:3], o2[:3]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=3e-6,
                                   err_msg=name)
    assert bool(jnp.all(o1[3] == o2[3]))


def test_pallas_boxed_solve_end_to_end(interpret_pallas):
    """Full boxed solve_batch through backward_impl='pallas' vs 'stacked':
    same trajectories, statuses, and in-box inputs."""
    import dataclasses
    from nmpc_tpu.core.types import BoxQPConfig, DDPConfig
    from nmpc_tpu.models.vertical import make_vertical_problem
    from nmpc_tpu import DDPSolver

    problem = make_vertical_problem(0.01)
    N, B = 20, 128
    base = DDPConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                     with_input_constraint=True,
                     boxqp=BoxQPConfig(max_ls_iter=16))
    rng = np.random.default_rng(1)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    us0 = jnp.zeros((B, N, 2), jnp.float32)
    r_st = DDPSolver(problem, dataclasses.replace(
        base, backward_impl="stacked")).solve_batch(
            jnp.float32(0.0), x0s, us0)
    r_pl = DDPSolver(problem, dataclasses.replace(
        base, backward_impl="pallas")).solve_batch(
            jnp.float32(0.0), x0s, us0)
    assert bool(jnp.all(r_st.status == r_pl.status))
    assert bool(jnp.all(r_st.iters == r_pl.iters))
    np.testing.assert_allclose(np.asarray(r_pl.us), np.asarray(r_st.us),
                               atol=1e-5)


def test_remat_solve_end_to_end(interpret_pallas):
    """Full solve_batch through backward_impl='remat' (the whole-iteration
    fused kernel: no derivative sweep at all) vs 'stacked', at a pre-chaos
    iteration budget (3 iterations — the same pattern as
    test_pallas_fmpc_solve_batch_pre_chaos_parity): statuses, iteration
    counts, and trajectories agree tightly.  Longer iterated solves
    amplify kernel-level fp noise chaotically through near-threshold
    accept decisions (measured: ~1e-3 u drift and occasional ±1-iter
    flips by iteration 6 on mid-swing cart-pole lanes — the same
    documented iterated-fp32 divergence class as pallas-vs-stacked,
    bounded on the GPU by benchmarks/parity_gate.py's e2e entries)."""
    import dataclasses
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu import DDPSolver

    problem = make_cartpole_problem(0.01)
    N, B = 12, 128
    base = DDPConfig(horizon_steps=N, max_iter=3)
    rng = np.random.default_rng(7)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.1 * rng.normal(size=(B, 4))).astype(np.float32))
    us0 = jnp.zeros((B, N, 1), jnp.float32)
    r_st = DDPSolver(problem, dataclasses.replace(
        base, backward_impl="stacked")).solve_batch(
            jnp.float32(0.0), x0s, us0)
    # forward_impl pinned to "scan" so this comparison isolates the
    # BACKWARD delta (the fused-forward delta has its own e2e test,
    # test_forward_fused_solve_end_to_end)
    r_rm = DDPSolver(problem, dataclasses.replace(
        base, backward_impl="remat", forward_impl="scan")).solve_batch(
            jnp.float32(0.0), x0s, us0)
    assert bool(jnp.all(r_st.status == r_rm.status))
    assert bool(jnp.all(r_st.iters == r_rm.iters))
    np.testing.assert_allclose(np.asarray(r_rm.us), np.asarray(r_st.us),
                               atol=1e-5)


def test_forward_remat_matches_scan(interpret_pallas):
    """Fused selected-alpha rollout kernel (kernels/ddp_forward_remat.py)
    vs the lax.scan path: the kernel evaluates the same dynamics / cost
    traces on the same (x, u) values via the tile interpreter, so
    trajectories, per-stage costs, and in-order cost sums agree at
    fp-reassociation level."""
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.solvers import ddp as D
    from nmpc_tpu.kernels.ddp_forward_remat import (
        forward_remat_supported, forward_selected_remat)
    from nmpc_tpu.kernels.lanes import block_lanes, lane_factors

    p = make_cartpole_problem(0.01)
    c = DDPConfig(horizon_steps=12, max_iter=10)
    B = 256
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, 12, 1)).astype(np.float32) * 0.2)
    t0 = jnp.float32(0.3)   # nonzero so the in-kernel t_i recompute bites
    S_, L_ = lane_factors(B)
    xs_l, _ = D._rollout_lanes(p, c, t0, block_lanes(x0s, 0, S_, L_),
                               block_lanes(us, 0, S_, L_))
    us_l = block_lanes(us, 0, S_, L_)
    ks_l = jnp.asarray(rng.normal(size=(12, 1, S_, L_)).astype(np.float32)
                       * 0.1)
    Ks_l = jnp.asarray(rng.normal(size=(12, 1, 4, S_, L_)).astype(np.float32)
                       * 0.1)
    alpha_l = jnp.asarray(
        rng.uniform(0.1, 1.0, size=(S_, L_)).astype(np.float32))
    flat = lambda a: a.reshape(a.shape[:-2] + (B,))

    assert forward_remat_supported(p, 4, 1)
    o1 = D._forward_selected_lanes(p, c, t0, xs_l, us_l, ks_l, Ks_l, alpha_l)
    o2 = forward_selected_remat(p, c, t0, flat(xs_l), flat(us_l),
                                flat(ks_l), flat(Ks_l), flat(alpha_l))
    for a, b, tol in zip(o1, o2, (1e-5, 1e-5, 1e-5, 2e-5)):
        np.testing.assert_allclose(np.asarray(flat(jnp.asarray(a))),
                                   np.asarray(b), atol=tol)



def test_forward_fused_solve_end_to_end(interpret_pallas):
    """Full solve_batch with the fused forward kernels
    (forward_impl='fused') vs the scan paths (forward_impl='scan'), both
    on the remat backward, at a pre-chaos iteration budget (the
    test_remat_solve_end_to_end pattern): statuses, iteration counts, and
    trajectories agree tightly."""
    import dataclasses
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu import DDPSolver

    problem = make_cartpole_problem(0.01)
    N, B = 12, 128
    base = DDPConfig(horizon_steps=N, max_iter=3, backward_impl="remat")
    rng = np.random.default_rng(7)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.1 * rng.normal(size=(B, 4))).astype(np.float32))
    us0 = jnp.zeros((B, N, 1), jnp.float32)
    r_sc = DDPSolver(problem, dataclasses.replace(
        base, forward_impl="scan")).solve_batch(jnp.float32(0.0), x0s, us0)
    r_fu = DDPSolver(problem, dataclasses.replace(
        base, forward_impl="fused")).solve_batch(jnp.float32(0.0), x0s, us0)
    assert bool(jnp.all(r_sc.status == r_fu.status))
    assert bool(jnp.all(r_sc.iters == r_fu.iters))
    np.testing.assert_allclose(np.asarray(r_fu.us), np.asarray(r_sc.us),
                               atol=1e-5)
    # ls_mode sweep through the fused kernels: same accept decisions
    r_sw = DDPSolver(problem, dataclasses.replace(
        base, forward_impl="fused", ls_mode="sweep")).solve_batch(
            jnp.float32(0.0), x0s, us0)
    assert bool(jnp.all(r_fu.status == r_sw.status))
    assert bool(jnp.all(r_fu.iters == r_sw.iters))
    np.testing.assert_allclose(np.asarray(r_sw.us), np.asarray(r_fu.us),
                               atol=1e-5)


def test_remat_boxed_solve_end_to_end(interpret_pallas):
    """Full BOXED solve_batch through backward_impl='remat' (bounds and
    BoxQP inputs rematerialized in-kernel) vs 'stacked'."""
    import dataclasses
    from nmpc_tpu.core.types import BoxQPConfig, DDPConfig
    from nmpc_tpu.models.vertical import make_vertical_problem
    from nmpc_tpu import DDPSolver

    problem = make_vertical_problem(0.01)
    N, B = 20, 128
    base = DDPConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                     with_input_constraint=True,
                     boxqp=BoxQPConfig(max_ls_iter=16))
    rng = np.random.default_rng(1)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    us0 = jnp.zeros((B, N, 2), jnp.float32)
    r_st = DDPSolver(problem, dataclasses.replace(
        base, backward_impl="stacked")).solve_batch(
            jnp.float32(0.0), x0s, us0)
    # forward_impl pinned to "scan": isolate the backward delta (see
    # test_remat_solve_end_to_end / test_forward_fused_solve_end_to_end)
    r_rm = DDPSolver(problem, dataclasses.replace(
        base, backward_impl="remat", forward_impl="scan")).solve_batch(
            jnp.float32(0.0), x0s, us0)
    assert bool(jnp.all(r_st.status == r_rm.status))
    assert bool(jnp.all(r_st.iters == r_rm.iters))
    np.testing.assert_allclose(np.asarray(r_rm.us), np.asarray(r_st.us),
                               atol=1e-5)


def test_fmpc_forward_pallas_matches_scan(interpret_pallas):
    """Fused FMPC forward delta recursion (kernels/fmpc_forward_pallas.py)
    vs the lax.scan in _forward_bm: identical linear recursion on
    identical coefficients — agreement at fp-reassociation level."""
    from jax import lax
    from nmpc_tpu.kernels.ddp_backward import _mv
    from nmpc_tpu.kernels.fmpc_forward_pallas import (
        forward_fmpc_deltas_pallas)

    rng = np.random.default_rng(3)
    N, nx, nu, B = 20, 4, 2, 256
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.3)
    A, Bm, xb = f(N, nx, nx, B), f(N, nx, nu, B), f(N, nx, B)
    ks, Ks, dx0 = f(N, nu, B), f(N, nu, nx, B), f(nx, B)

    def fstep(dx, inp):
        A_, Bm_, x_bar, k, K = inp
        du = _mv(K, dx) + k
        return _mv(A_, dx) + _mv(Bm_, du) + x_bar, (dx, du)

    _, (dxs, dus) = lax.scan(fstep, dx0, (A, Bm, xb, ks, Ks))
    dx_T = _mv(A[-1], dxs[-1]) + _mv(Bm[-1], dus[-1]) + xb[-1]
    dxs = jnp.concatenate([dxs, dx_T[None]], axis=0)
    o_dxs, o_dus = forward_fmpc_deltas_pallas(A, Bm, xb, ks, Ks, dx0)
    np.testing.assert_allclose(np.asarray(o_dxs), np.asarray(dxs),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(o_dus), np.asarray(dus),
                               atol=2e-5)


def test_fmpc_forward_fused_solve_end_to_end(interpret_pallas):
    """Full FMPC solve_batch with forward_impl='fused' vs 'scan' (both on
    the stacked backward): statuses, iters, and converged variables agree
    tightly at a pre-chaos iteration budget."""
    import dataclasses
    from nmpc_tpu.core.types import FmpcConfig, fmpc_variable_reset
    from nmpc_tpu.models.oscillator import make_oscillator_problem
    from nmpc_tpu.solvers.fmpc import FmpcSolver

    p = make_oscillator_problem(0.01)
    B, N = 128, 20
    nx, nu, ng = p.state_dim, p.input_dim, p.ineq_dim
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((0.3 * rng.normal(size=(B, nx))).astype(np.float32))
    var1 = fmpc_variable_reset(N, nx, nu, ng, dtype=jnp.float32)
    vars_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), var1)
    eps0 = jnp.full((B,), 1e-4, jnp.float32)
    base = FmpcConfig(horizon_steps=N, max_iter=3,
                      init_complementary_variable=True)
    res = {}
    for fwd in ("scan", "fused"):
        c = dataclasses.replace(base, backward_impl="stacked",
                                forward_impl=fwd)
        res[fwd] = FmpcSolver(p, c).solve_batch(
            jnp.float32(0.0), x0s, vars_b, eps0)
    a, b = res["scan"], res["fused"]
    assert bool(jnp.all(a.status == b.status))
    assert bool(jnp.all(a.iters == b.iters))
    np.testing.assert_allclose(np.asarray(b.variable.us),
                               np.asarray(a.variable.us), atol=2e-4)


def _fmpc_backward_case(break_if_llt_fails):
    from nmpc_tpu.core.types import FmpcConfig, FmpcVariable
    from nmpc_tpu.models.oscillator import make_oscillator_problem
    from nmpc_tpu.solvers import fmpc as F
    from nmpc_tpu.kernels.fmpc_backward_pallas import backward_fmpc_pallas

    p = make_oscillator_problem(0.01)
    N, B = 10, 128
    c = FmpcConfig(horizon_steps=N, max_iter=10,
                   break_if_llt_fails=break_if_llt_fails)
    rng = np.random.default_rng(0)
    f32 = np.float32
    var = FmpcVariable(
        xs=jnp.asarray(rng.normal(size=(N + 1, 2, B)).astype(f32) * 0.3),
        us=jnp.asarray(rng.normal(size=(N, 1, B)).astype(f32) * 0.3),
        lambdas=jnp.asarray(rng.normal(size=(N + 1, 2, B)).astype(f32) * 0.3),
        ss=jnp.asarray(0.2 + rng.uniform(size=(N, 3, B)).astype(f32)),
        nus=jnp.asarray(0.2 + rng.uniform(size=(N, 3, B)).astype(f32)),
    )
    ts = jnp.float32(0.0) + p.dt * jnp.arange(N, dtype=jnp.float32)
    gms = jax.vmap(lambda t: p.ineq_mask_at(t).astype(jnp.float32))(ts)
    eps = jnp.full((B,), 1e-4, jnp.float32)
    co = F._coeffs_bm(p, c, jnp.float32(0.0), var)

    o1 = F._backward_bm(p, c, co, var.ss, var.nus, gms, eps)
    o2 = backward_fmpc_pallas(p, c, co, var.ss, var.nus, gms, eps)
    return o1, o2


@pytest.mark.parametrize("break_if_llt_fails", [False, True])
def test_pallas_fmpc_backward_matches_stacked(interpret_pallas,
                                              break_if_llt_fails):
    """Fused FMPC condensed-Riccati kernel vs the stacked XLA scan
    (solvers/fmpc.py::_backward_bm; reference FmpcSolver.hpp:524-665)."""
    o1, o2 = _fmpc_backward_case(break_if_llt_fails)
    names = ["ks", "Ks", "svecs", "Ps"]
    for name, a, b in zip(names, o1[:4], o2[:4]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=3e-5, err_msg=name)
    assert bool(jnp.all(o1[4] == o2[4]))  # ok_pd
    assert bool(jnp.all(o1[5] == o2[5]))  # finite


def _fmpc_solve_both(max_iter, x0_scale, seed=2, B=128, N=20):
    from nmpc_tpu.core.types import FmpcConfig, fmpc_variable_reset
    from nmpc_tpu.models.oscillator import make_oscillator_problem
    from nmpc_tpu.solvers.fmpc import FmpcSolver

    p = make_oscillator_problem(0.01)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.normal(size=(B, 2)).astype(np.float32) * x0_scale)
    var1 = fmpc_variable_reset(N, 2, 1, 3, dtype=jnp.float32)
    vars_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), var1)
    eps0 = jnp.full((B,), 1e-4, jnp.float32)
    outs = {}
    for impl in ("stacked", "pallas"):
        c = FmpcConfig(horizon_steps=N, max_iter=max_iter, backward_impl=impl,
                       init_complementary_variable=True)
        outs[impl] = FmpcSolver(p, c).solve_batch(0.0, x0s, vars_b, eps0)
    return outs["stacked"], outs["pallas"]


def test_pallas_fmpc_solve_batch_end_to_end(interpret_pallas):
    """Full batched PDIP solve with backward_impl='pallas' vs the stacked
    path: the parity contract is CONVERGED-lane agreement.

    Evidence for the contract (tools/debug_fmpc_pallas.py, measured on this
    exact problem): single-backward parity is ~2e-7 relative (the kernel is
    numerically equivalent to the stacked scan), but the PDIP iteration is
    chaotic on lanes whose KKT error is blowing up — a 1-ulp perturbation
    of x0 on the STACKED PATH ALONE produces max|du| = 2e-3 after 5
    iterations, larger than the pallas-vs-stacked difference.  Trajectory
    parity on diverging lanes is therefore not a property either
    implementation has against itself; the meaningful contract is that
    converged lanes agree tightly and the SET of converged lanes is
    identical (measured converged-lane max|du| = 9.5e-7).  Diverging lanes
    may differ even in which failure status they hit (ERROR_IN_BACKWARD vs
    MAX_ITERATION_REACHED: which iteration produces the first non-finite
    value is itself chaotic), so failure modes are not asserted."""
    from nmpc_tpu.core.types import FmpcStatus

    a, b = _fmpc_solve_both(max_iter=20, x0_scale=0.3)
    st_a = np.asarray(a.status)
    st_b = np.asarray(b.status)
    conv = st_a == int(FmpcStatus.SUCCEEDED)
    assert np.array_equal(conv, st_b == int(FmpcStatus.SUCCEEDED))
    assert conv.sum() >= 32  # the contract must bite on a real population
    us_a = np.asarray(a.variable.us)[conv]
    us_b = np.asarray(b.variable.us)[conv]
    np.testing.assert_allclose(us_b, us_a, atol=1e-5)
    kkt_a = np.asarray(a.kkt_error)[conv]
    kkt_b = np.asarray(b.kkt_error)[conv]
    np.testing.assert_allclose(kkt_b, kkt_a, atol=1e-4)


def test_pallas_fmpc_solve_batch_pre_chaos_parity(interpret_pallas):
    """Before the chaotic amplification kicks in (2 PDIP iterations), the
    full batch — including lanes that will later diverge — matches the
    stacked path tightly (measured max|du| = 6.7e-8 at k=2)."""
    a, b = _fmpc_solve_both(max_iter=2, x0_scale=0.5)
    assert np.array_equal(np.asarray(a.status), np.asarray(b.status))
    assert np.array_equal(np.asarray(a.iters), np.asarray(b.iters))
    np.testing.assert_allclose(np.asarray(b.variable.us),
                               np.asarray(a.variable.us), atol=1e-5)


def _make_two_input_problem():
    """Synthetic nx=2, nu=2, ng=2 problem so G is a genuine 2x2 block and
    the Gauss-Jordan tile inverse (_inv_t) runs its pivoting logic."""
    from nmpc_tpu.core.problem import Problem

    dt = 0.02

    def dyn(t, x, u):
        A = jnp.array([[1.0, dt], [-0.3 * dt, 1.0 - 0.1 * dt]], x.dtype)
        B = jnp.array([[0.5 * dt, 0.0], [dt, 0.7 * dt]], x.dtype)
        return A @ x + B @ u

    def rc(t, x, u):
        return 0.5 * (jnp.sum(x * x) + 0.1 * jnp.sum(u * u))

    def tc(t, x):
        return 0.5 * jnp.sum(x * x)

    def g(t, x, u):
        return jnp.array([u[0] - 1.0, -u[1] - 1.0], x.dtype)

    return Problem(dt=dt, state_dim=2, input_dim=2, dynamics=dyn,
                   running_cost=rc, terminal_cost=tc, ineq_dim=2,
                   ineq_const=g)


@pytest.mark.parametrize("break_if_llt_fails", [False, True])
def test_pallas_fmpc_backward_nonpd_fallback(interpret_pallas,
                                             break_if_llt_fails):
    """Non-PD G stages: with break_if_llt_fails=False the Gauss-Jordan LU
    fallback (_inv_t) must match the stacked path's _inv_bl gains; with
    True the ok_pd=False flag must propagate identically
    (reference LDLT -> FullPivLU fallback, FmpcSolver.hpp:594-618)."""
    from nmpc_tpu.core.types import FmpcConfig, FmpcVariable
    from nmpc_tpu.solvers import fmpc as F
    from nmpc_tpu.kernels.fmpc_backward_pallas import backward_fmpc_pallas

    p = _make_two_input_problem()
    N, B = 8, 128
    c = FmpcConfig(horizon_steps=N, max_iter=10,
                   break_if_llt_fails=break_if_llt_fails)
    rng = np.random.default_rng(7)
    f32 = np.float32
    var = FmpcVariable(
        xs=jnp.asarray(rng.normal(size=(N + 1, 2, B)).astype(f32) * 0.3),
        us=jnp.asarray(rng.normal(size=(N, 2, B)).astype(f32) * 0.3),
        lambdas=jnp.asarray(rng.normal(size=(N + 1, 2, B)).astype(f32) * 0.3),
        ss=jnp.asarray(0.2 + rng.uniform(size=(N, 2, B)).astype(f32)),
        nus=jnp.asarray(0.2 + rng.uniform(size=(N, 2, B)).astype(f32)),
    )
    ts = jnp.float32(0.0) + p.dt * jnp.arange(N, dtype=jnp.float32)
    gms = jax.vmap(lambda t: p.ineq_mask_at(t).astype(jnp.float32))(ts)
    eps = jnp.full((B,), 1e-4, jnp.float32)
    co = F._coeffs_bm(p, c, jnp.float32(0.0), var)

    # poison Luu on stages 2 and 5 so G = dt*Luu + D'(nu/s)D + B'PB goes
    # solidly indefinite there (half the batch, to also test mixed lanes)
    bad = np.zeros((N, 1, 1, B), np.float32)
    bad[2, :, :, : B // 2] = 1.0
    bad[5, :, :, : B // 2] = 1.0
    eye = np.eye(2, dtype=np.float32)[None, :, :, None]
    Luu_bad = jnp.asarray(
        np.asarray(co.Luu) * (1.0 - bad) + bad * (-400.0) * eye)
    co = co._replace(Luu=Luu_bad)

    o1 = F._backward_bm(p, c, co, var.ss, var.nus, gms, eps)
    o2 = backward_fmpc_pallas(p, c, co, var.ss, var.nus, gms, eps)
    ok_pd = np.asarray(o1[4])
    if break_if_llt_fails:
        assert not ok_pd[: B // 2].any()   # poisoned lanes flagged
        assert ok_pd[B // 2:].all()        # clean lanes unaffected
    else:
        assert ok_pd.all()
        names = ["ks", "Ks", "svecs", "Ps"]
        for name, x, y in zip(names, o1[:4], o2[:4]):
            np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                       atol=5e-4, err_msg=name)
    assert np.array_equal(np.asarray(o1[4]), np.asarray(o2[4]))  # ok_pd
    assert np.array_equal(np.asarray(o1[5]), np.asarray(o2[5]))  # finite


def test_pallas_backward_reg_type2(interpret_pallas):
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.solvers import ddp as D
    from nmpc_tpu.kernels.ddp_backward import backward_stacked, stack_derivs
    import nmpc_tpu.kernels.ddp_backward_pallas as P

    p = make_cartpole_problem(0.01)
    c = DDPConfig(horizon_steps=6, max_iter=10, reg_type=2)
    B = 128
    rng = np.random.default_rng(1)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, 6, 1)).astype(np.float32) * 0.2)
    xs, _ = D._rollout_stacked(p, c, 0.0, x0s, us)
    Ds, VxT, VxxT = jax.vmap(
        functools.partial(D._derivative_sweep, p, c),
        in_axes=(None, 0, 0))(0.0, xs, us)
    S = stack_derivs(Ds.Fx, Ds.Fu, Ds.Lx, Ds.Lu, Ds.Lxx, Ds.Luu, Ds.Lxu)
    lam = jnp.full((B,), 0.5, jnp.float32)
    o1 = backward_stacked(c, S, jnp.moveaxis(VxT, 0, -1),
                          jnp.moveaxis(VxxT, 0, -1), lam)
    o2 = P.backward_pallas(c, S, jnp.moveaxis(VxT, 0, -1),
                           jnp.moveaxis(VxxT, 0, -1), lam)
    np.testing.assert_allclose(np.asarray(o2[0]), np.asarray(o1[0]),
                               atol=2e-5)
