"""Closed-loop tests for the bipedal and vertical-motion DDP families.

Reference assertions reproduced: bipedal |planned_zmp - ref_zmp| < 1e-2 each
step and final |CoM - ZMP| < 1e-2 (``TestDDPBipedal.cpp:252-273``); vertical
motion final |pos - ref| < 1e-2, |vel| < 1e-2 with and without force limits
(``TestDDPVerticalMotion.cpp:329-332``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from nmpc_tpu import DDPConfig, DDPSolver
from nmpc_tpu.models.bipedal import (
    example_omega2_func,
    example_ref_zmp_func,
    make_bipedal_problem,
)
from nmpc_tpu.models.vertical import make_vertical_problem, num_contacts
from nmpc_tpu.mpc.driver import run_mpc, shift_warm_start


def test_bipedal_mpc():
    dt = 0.01
    end_t = 20.0
    horizon_steps = 300
    ref_zmp = example_ref_zmp_func(end_t)
    problem = make_bipedal_problem(dt, ref_zmp, example_omega2_func())
    solver = DDPSolver(problem, DDPConfig(horizon_steps=horizon_steps,
                                          max_iter=500))
    zmp_errs = []

    def cb(t, x, u, res):
        zmp_errs.append(abs(float(u[0]) - float(ref_zmp(t))))

    log = run_mpc(solver, jnp.zeros(2), t0=0.0, end_t=end_t, callback=cb)
    assert max(zmp_errs) < 1e-2
    final_x = log.xs[-1]
    ref = float(ref_zmp(end_t))
    assert abs(final_x[0] - ref) < 1e-2
    assert abs(final_x[1]) < 1e-2


@pytest.mark.parametrize("with_constraint", [True, False])
def test_vertical_motion_mpc(with_constraint):
    dt = 0.01
    horizon_steps = 300
    problem = make_vertical_problem(dt, with_limits=with_constraint)
    solver = DDPSolver(
        problem,
        DDPConfig(horizon_steps=horizon_steps, max_iter=3,
                  initial_lambda=1e-6,
                  with_input_constraint=with_constraint),
    )
    log = run_mpc(solver, jnp.array([1.2, 0.0]), t0=0.0, end_t=10.0)
    # per-step envelope (TestDDPVerticalMotion.cpp:303-305)
    ref = np.where(log.ts + 1e-6 < 8.0, 1.0, 0.0)
    assert np.all(np.abs(log.xs[:, 0] - ref) < 1.0)
    # final convergence
    assert abs(log.xs[-1, 0] - 0.0) < 1e-2
    assert abs(log.xs[-1, 1]) < 1e-2
    if with_constraint:
        assert log.us.min() >= -1e-9
        assert log.us.max() <= 30.0 + 1e-9
    # masked dims stay at zero force
    for i, t in enumerate(log.ts):
        n = int(num_contacts(t))
        assert np.all(np.abs(log.us[i, n:]) < 1e-12)


def test_shift_warm_start_mask_change():
    problem = make_vertical_problem(0.01)
    N = 10
    us = jnp.ones((N, 2))
    # at t=2.0+ the terminal mask flips from 1 to 2 active contacts around
    # t_term crossing 2.0; pick t_next so t_term_old has 1, t_term_new has 2
    t_next = 2.0 - 10 * 0.01 + 0.005
    shifted = shift_warm_start(problem, t_next, us)
    assert shifted.shape == us.shape


def test_boxed_batch_matches_single():
    """Boxed-DDP stacked batch path == vmapped single solves (exercises the
    batch-minor BoxQP, kernels/ddp_backward.py::boxqp_stacked)."""
    from nmpc_tpu.models.cartpole import make_cartpole_problem

    problem = make_cartpole_problem(0.01, input_limits=(-15.0, 15.0))
    solver = DDPSolver(problem, DDPConfig(horizon_steps=40, max_iter=10,
                                          with_input_constraint=True))
    B = 4
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                      + 0.1 * rng.normal(size=(B, 4)))
    us0 = jnp.zeros((B, 40, 1))
    batch = solver.solve_batch(0.0, x0s, us0)
    for i in range(B):
        single = solver.solve(0.0, x0s[i], us0[i])
        assert int(batch.status[i]) == int(single.status)
        assert int(batch.iters[i]) == int(single.iters)
        np.testing.assert_allclose(np.asarray(batch.us[i]),
                                   np.asarray(single.us), atol=1e-9)


def test_boxed_batch_vertical_masked():
    """Boxed stacked path with time-varying masked dims (vertical motion)."""
    problem = make_vertical_problem(0.01)
    solver = DDPSolver(problem, DDPConfig(horizon_steps=60, max_iter=3,
                                          initial_lambda=1e-6,
                                          with_input_constraint=True))
    B = 3
    rng = np.random.default_rng(1)
    x0s = jnp.asarray(np.tile([1.2, 0.0], (B, 1))
                      + 0.05 * rng.normal(size=(B, 2)))
    us0 = jnp.zeros((B, 60, 2))
    batch = solver.solve_batch(1.8, x0s, us0)  # horizon spans the dim switch
    for i in range(B):
        single = solver.solve(1.8, x0s[i], us0[i])
        np.testing.assert_allclose(np.asarray(batch.us[i]),
                                   np.asarray(single.us), atol=1e-9)
        assert int(batch.status[i]) == int(single.status)


def test_ls_modes_identical_results():
    """The three line-search modes (adaptive "auto", static "head",
    static "sweep") make IDENTICAL accept decisions — only the evaluation
    schedule differs (reference serial loop
    DDPSolver.hpp:242-265).  Cart-pole from the hanging pose backtracks
    in early iterations and takes full steps later, so both paths and the
    adaptive switch are exercised."""
    import dataclasses

    from nmpc_tpu.models.cartpole import make_cartpole_problem

    problem = make_cartpole_problem(0.01)
    base = DDPConfig(horizon_steps=40, max_iter=12)
    B = 4
    rng = np.random.default_rng(5)
    x0s = jnp.asarray(np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                      + 0.1 * rng.normal(size=(B, 4)))
    us0 = jnp.zeros((B, 40, 1))
    results = {}
    for mode in ("auto", "serial", "head", "sweep"):
        solver = DDPSolver(problem, dataclasses.replace(base, ls_mode=mode))
        results[mode] = solver.solve_batch(0.0, x0s, us0)
    for mode in ("serial", "head", "sweep"):
        r, r0 = results[mode], results["auto"]
        assert np.array_equal(np.asarray(r.status), np.asarray(r0.status))
        assert np.array_equal(np.asarray(r.iters), np.asarray(r0.iters))
        np.testing.assert_allclose(np.asarray(r.us), np.asarray(r0.us),
                                   atol=1e-12, err_msg=mode)
        np.testing.assert_allclose(np.asarray(r.trace.alpha),
                                   np.asarray(r0.trace.alpha),
                                   atol=1e-12, err_msg=mode)


def test_ls_modes_identical_results_fp32():
    """Line-search mode identity at fp32, BIT-exact
   : the head path's alpha[0] cost sum
    is now accumulated inside the selected-alpha rollout scan with the
    same order and dtype as the sweep path's per-alpha sums, so accept
    decisions cannot diverge even when candidate ratios sit within fp32
    noise of ``cost_update_ratio_thre``.  Cart-pole swing-up backtracks
    early and full-steps late, crossing the accept threshold repeatedly.
    (Verified on this workload: the pre-fix ``jnp.sum`` head accumulation
    differs from the sweep sums by ~5e-5 at fp32; the in-scan accumulator
    matches bit-for-bit, making the equality asserted here structural
    rather than luck.)"""
    import dataclasses

    from nmpc_tpu.models.cartpole import make_cartpole_problem

    problem = make_cartpole_problem(0.01)
    base = DDPConfig(horizon_steps=40, max_iter=12)
    B = 8
    rng = np.random.default_rng(11)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.1 * rng.normal(size=(B, 4))).astype(np.float32))
    us0 = jnp.zeros((B, 40, 1), jnp.float32)
    results = {}
    for mode in ("auto", "serial", "head", "sweep"):
        solver = DDPSolver(problem, dataclasses.replace(base, ls_mode=mode))
        results[mode] = solver.solve_batch(jnp.float32(0.0), x0s, us0)
    for mode in ("serial", "head", "sweep"):
        r, r0 = results[mode], results["auto"]
        assert r.us.dtype == jnp.float32
        assert np.array_equal(np.asarray(r.status), np.asarray(r0.status))
        assert np.array_equal(np.asarray(r.iters), np.asarray(r0.iters))
        assert np.array_equal(np.asarray(r.us), np.asarray(r0.us)), mode
        assert np.array_equal(np.asarray(r.trace.alpha),
                              np.asarray(r0.trace.alpha)), mode
