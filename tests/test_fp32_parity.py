"""fp32 tolerance audit: the fp32 precision path vs the fp64 golden solver.

BASELINE.md requires u-trajectory parity at the reference configuration
(cart-pole, horizon 100).  The framework meets 1e-8 at solver precision
(fp64, tests/test_ddp_cartpole.py).  This audit certifies the fp32
path: the achievable u-parity there is governed by problem conditioning —
Quu ~ 0.02 for this cost scaling, so fp32 gradient noise (~1e-5 absolute on
costs ~300) maps to u noise ~ noise/Quu ~ 4e-4 in the flat valley — while
*cost* parity is ~1e-6 relative (the solutions are equally optimal).  The
audit pins both numbers and the fp32-calibrated termination behavior
(DDPConfig.for_fp32; with fp64 thresholds the solver cannot detect
convergence below fp32 noise and escalates lambda to failure).

The conditioning-floor claim was verified directly: running the ENTIRE
backward pass in fp64 inside the otherwise-fp32 pipeline does not improve
u-parity (4.4e-4 — so compensated/Kahan carries, which are strictly
weaker, cannot either),
while stiffening Quu by 100x tightens it to 1.2e-4 —
``test_stiff_quu_tightens_parity`` pins that scaling law.

A complementary experiment, extending the fp64 islands to the FORWARD path too (x-carry, line-search
u formation and costs at fp64 in all three rollouts, fp32 backward
kernel) measured 4.4e-4 — WORSE than derivative-islands-only (1.97e-4),
not better.  The placement of the solution inside the flat optimality
valley is chaotic in the fp32 backward-gain noise (~3e-6 relative on
gains -> ~1.5e-4 u placement via Quu~0.02), so no partial-fp64
configuration can track the fp64 golden below that; only a full-fp64
solve (1e-8, test_fp32_parity_and_termination's golden) does.  The
calibrated fp32 bound is therefore pinned at 2e-4 with
deriv_dtype="float64" (test_deriv_dtype_float64_tightens_parity) and
5e-4 all-fp32 — BASELINE.md's 1e-4 row is met at fp64, bounded by
conditioning at fp32."""

import numpy as np
import jax
import jax.numpy as jnp

from nmpc_tpu import DDPConfig, DDPSolver, DDPStatus
from nmpc_tpu.models.cartpole import make_cartpole_problem

from golden.cartpole_numpy import CartPoleGolden
from golden.ddp_numpy import GoldenConfig, GoldenDDP

DT = 0.01
HORIZON = 100


def test_fp32_parity_and_termination():
    problem = make_cartpole_problem(DT)
    config = DDPConfig(horizon_steps=HORIZON, max_iter=50).for_fp32()
    solver = DDPSolver(problem, config)
    golden = GoldenDDP(CartPoleGolden(DT),
                       GoldenConfig(horizon_steps=HORIZON, max_iter=50))

    x0_64 = np.array([0.0, np.pi, 0.0, 0.0])
    gres = golden.solve(0.0, x0_64, np.zeros((HORIZON, 1)))
    assert gres["status"] == "succeeded"

    x0_32 = jnp.asarray(x0_64, jnp.float32)
    us0_32 = jnp.zeros((HORIZON, 1), jnp.float32)
    res32 = solver.solve(jnp.float32(0.0), x0_32, us0_32)

    # fp32-calibrated thresholds terminate cleanly (not lambda overflow)
    assert int(res32.status) == DDPStatus.SUCCEEDED

    u64 = gres["us"][:, 0]
    u32 = np.asarray(res32.us)[:, 0]
    scale = np.abs(u64).max()
    assert np.abs(u32 - u64).max() / scale < 5e-4   # conditioning-limited
    # solution quality: cost parity well below u-space noise
    c64 = gres["costs"].sum()
    c32 = float(jnp.sum(res32.costs))
    assert abs(c32 - c64) / c64 < 1e-5

    # batched fp32 (stacked kernels): since the dtype-boundary casts, this
    # path is all-fp32 end to end on CPU exactly as on the chip (no silent
    # float64 promotion through model constants under x64), so its honest
    # conditioning-limited u-noise is ~1e-3 relative; cost parity stays tight.
    res_b = solver.solve_batch(jnp.float32(0.0), x0_32[None], us0_32[None])
    u32b = np.asarray(res_b.us)[0, :, 0]
    assert np.abs(u32b - u64).max() / scale < 2e-3
    cb = float(jnp.sum(res_b.costs[0]))
    assert abs(cb - c64) / c64 < 1e-5
    assert int(res_b.status[0]) == DDPStatus.SUCCEEDED


def test_stiff_quu_tightens_parity():
    """The fp32 u-parity floor is conditioning: stiffening the control
    weight 100x (Quu ~ 2.0 instead of 0.02) narrows the optimality valley
    and the fp32 solution tracks the fp64 golden ~3x tighter — evidence the
    floor is curvature-limited, not an accumulation artifact."""
    cw = __import__("nmpc_tpu.models.cartpole", fromlist=["CartPoleCostWeight"]
                    ).CartPoleCostWeight(running_u=(0.1,))
    problem = make_cartpole_problem(DT, cost_weight=cw)
    solver = DDPSolver(problem,
                       DDPConfig(horizon_steps=HORIZON, max_iter=50).for_fp32())
    golden = GoldenDDP(CartPoleGolden(DT, wru=(0.1,)),
                       GoldenConfig(horizon_steps=HORIZON, max_iter=50))
    gres = golden.solve(0.0, np.array([0.0, np.pi, 0.0, 0.0]),
                        np.zeros((HORIZON, 1)))
    res = solver.solve(jnp.float32(0.0),
                       jnp.asarray([0.0, np.pi, 0.0, 0.0], jnp.float32),
                       jnp.zeros((HORIZON, 1), jnp.float32))
    assert int(res.status) == DDPStatus.SUCCEEDED
    u64 = gres["us"][:, 0]
    u32 = np.asarray(res.us)[:, 0]
    assert np.abs(u32 - u64).max() / np.abs(u64).max() < 1.5e-4


def test_fp64_meets_1e4_target():
    """The BASELINE 1e-4 u-parity target, met with margin at fp64."""
    problem = make_cartpole_problem(DT)
    solver = DDPSolver(problem, DDPConfig(horizon_steps=HORIZON, max_iter=50))
    golden = GoldenDDP(CartPoleGolden(DT),
                       GoldenConfig(horizon_steps=HORIZON, max_iter=50))
    gres = golden.solve(0.0, np.array([0.0, np.pi, 0.0, 0.0]),
                        np.zeros((HORIZON, 1)))
    res = solver.solve(0.0, jnp.array([0.0, np.pi, 0.0, 0.0]),
                       jnp.zeros((HORIZON, 1)))
    err = np.abs(np.asarray(res.us)[:, 0] - gres["us"][:, 0]).max()
    assert err < 1e-4 * np.abs(gres["us"]).max()
    assert err < 1e-8  # actual margin


def test_deriv_dtype_float64_tightens_parity():
    """Mixed precision: fp64 derivative islands inside an
    otherwise-fp32 solve.  The r2 floor audit located the fp32 u-parity
    floor in the derivative/forward path conditioning; deriv_dtype='float64'
    evaluates the dynamics/cost quadraticizations in fp64 (cast back to
    fp32 for the backward kernels) and must tighten batched u-parity vs the
    all-fp32 path.  The achieved number is pinned below."""
    problem = make_cartpole_problem(DT)
    golden = GoldenDDP(CartPoleGolden(DT),
                       GoldenConfig(horizon_steps=HORIZON, max_iter=50))
    gres = golden.solve(0.0, np.array([0.0, np.pi, 0.0, 0.0]),
                        np.zeros((HORIZON, 1)))
    u64 = gres["us"][:, 0]
    scale = np.abs(u64).max()

    x0_32 = jnp.asarray([0.0, np.pi, 0.0, 0.0], jnp.float32)
    us0_32 = jnp.zeros((HORIZON, 1), jnp.float32)

    errs = {}
    for dd in ("same", "float64"):
        cfg = DDPConfig(horizon_steps=HORIZON, max_iter=50,
                        deriv_dtype=dd).for_fp32()
        res = DDPSolver(problem, cfg).solve_batch(
            jnp.float32(0.0), x0_32[None], us0_32[None])
        assert int(res.status[0]) == DDPStatus.SUCCEEDED
        assert res.us.dtype == jnp.float32  # islands stay internal
        errs[dd] = np.abs(np.asarray(res.us)[0, :, 0] - u64).max() / scale

    # fp64 islands must tighten the batched fp32 floor measurably, and land
    # within ~2x of the 1e-4 BASELINE target (the floor audit's prediction)
    assert errs["float64"] < 0.5 * errs["same"]
    assert errs["float64"] < 2e-4


def test_deriv_dtype_requires_x64():
    import pytest as _pytest

    problem = make_cartpole_problem(DT)
    cfg = DDPConfig(deriv_dtype="float64")
    enabled = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", False)
        with _pytest.raises(ValueError, match="jax_enable_x64"):
            DDPSolver(problem, cfg)
    finally:
        jax.config.update("jax_enable_x64", enabled)
