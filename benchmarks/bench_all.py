"""Full benchmark suite over the BASELINE.json configurations.

Covers the five reference-derived configs plus the p99-latency check
against the reference's real-time budget (4 ms MPC tick,
``TestDDPCartPole.cpp:302``).  Prints one JSON line per benchmark.
``bench.py`` at the repo root remains the single-line headline metric.

Run on the GPU, in one process:  python benchmarks/bench_all.py [name ...]
Every line names the device; a failed row is reported and makes the
script exit non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _timeit(fn, n=20):
    """Median wall time of ``fn()`` over ``n`` fenced calls
    (benchmarks/timing.py)."""
    from benchmarks.timing import median_time

    return median_time(fn, reps=n)


def bench_ddp_cartpole():
    """Config #1: DDP cart-pole swing-up, horizon 100, batched."""
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem

    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=100, max_iter=10))
    B = 4096
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us0 = jnp.zeros((B, 100, 1), jnp.float32)
    dt = _timeit(lambda: solver.solve_batch(jnp.float32(0.0), x0s, us0))
    return {"metric": "ddp_cartpole_solves_per_s", "value": round(B / dt, 1),
            "unit": "solves/s", "vs_baseline": round(B / dt / 10_000.0, 3)}


def bench_ddp_bipedal():
    """Config #2: bipedal CoM-ZMP with time-varying reference, horizon 300."""
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.bipedal import (example_omega2_func,
                                         example_ref_zmp_func,
                                         make_bipedal_problem)

    problem = make_bipedal_problem(0.01, example_ref_zmp_func(20.0),
                                   example_omega2_func())
    solver = DDPSolver(problem, DDPConfig(horizon_steps=300, max_iter=10))
    B = 2048
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    us0 = jnp.zeros((B, 300, 1), jnp.float32)
    dt = _timeit(lambda: solver.solve_batch(jnp.float32(0.0), x0s, us0))
    return {"metric": "ddp_bipedal_solves_per_s", "value": round(B / dt, 1),
            "unit": "solves/s", "vs_baseline": None}


def bench_boxed_ddp_vertical():
    """Config #3: boxed DDP with control limits + time-varying input dims."""
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.vertical import make_vertical_problem

    problem = make_vertical_problem(0.01)
    solver = DDPSolver(problem, DDPConfig(horizon_steps=100, max_iter=3,
                                          initial_lambda=1e-6,
                                          with_input_constraint=True))
    B = 1024
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    us0 = jnp.zeros((B, 100, 2), jnp.float32)
    dt = _timeit(lambda: solver.solve_batch(jnp.float32(0.0), x0s, us0))
    return {"metric": "boxed_ddp_vertical_solves_per_s",
            "value": round(B / dt, 1), "unit": "solves/s",
            "vs_baseline": None}


def bench_boxed_ddp_centroidal():
    """Wide-input boxed DDP: centroidal motion (nx=9, nu=16 friction-
    pyramid ridges) with unilateral force bounds 0 <= u <= f_max.

    This is the shape class the backward-kernel ``auto`` rule routes to
    the STACKED BoxQP (the fused kernel unrolls nu^3 in-kernel QP work
    and is gated to nu <= 2) — this row prices that gate.  Reference
    flagship: ``TestDDPCentroidalMotion.cpp:24-204`` +
    ``BoxQP.h:141-347``."""
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.centroidal import make_centroidal_problem

    problem = make_centroidal_problem(0.03, force_limits=(0.0, 1000.0))
    solver = DDPSolver(problem, DDPConfig(horizon_steps=100, max_iter=3,
                                          initial_lambda=1e-6,
                                          with_input_constraint=True))
    B = 256
    rng = np.random.default_rng(0)
    x0 = np.concatenate([[0.0, 0.0, 1.0], np.zeros(6)])
    x0s = jnp.asarray((np.tile(x0, (B, 1))
                       + 0.02 * rng.normal(size=(B, 9))).astype(np.float32))
    us0 = jnp.full((B, 100, 16), 5.0, jnp.float32)
    dt = _timeit(lambda: solver.solve_batch(jnp.float32(0.0), x0s, us0))
    return {"metric": "boxed_ddp_centroidal_nu16_solves_per_s",
            "value": round(B / dt, 1), "unit": "solves/s",
            "vs_baseline": None}


def bench_fmpc_oscillator():
    """Config #4: FMPC (DMS + PDIP + Riccati) with state/input constraints."""
    import jax as _jax
    from nmpc_tpu import FmpcConfig, FmpcSolver, fmpc_variable_reset
    from nmpc_tpu.models.oscillator import make_oscillator_problem

    solver = FmpcSolver(make_oscillator_problem(0.01),
                        FmpcConfig(horizon_steps=100, max_iter=5))
    B = 1024
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, 1.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    var1 = fmpc_variable_reset(100, 2, 1, 3, dtype=jnp.float32)
    vars_b = _jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), var1)
    epss = jnp.full((B,), 1e-4, jnp.float32)
    dt = _timeit(lambda: solver.solve_batch(jnp.float32(0.0), x0s, vars_b, epss),
                 n=48)
    return {"metric": "fmpc_oscillator_solves_per_s",
            "value": round(B / dt, 1), "unit": "solves/s",
            "vs_baseline": None}


def bench_fmpc_cartpole_serving():
    """FMPC at the serving shape (cart-pole N=100, ng=4, B=4096), where
    ``auto`` routes to the fused backward and forward kernels.
    kkt_thre=0 pins fixed work so the row is comparable across runs."""
    import jax as _jax
    from nmpc_tpu import FmpcConfig, FmpcSolver, fmpc_variable_reset
    from nmpc_tpu.models.cartpole import make_cartpole_fmpc_problem

    p = make_cartpole_fmpc_problem(0.01)
    solver = FmpcSolver(p, FmpcConfig(horizon_steps=100, max_iter=5,
                                      kkt_error_thre=0.0,
                                      init_complementary_variable=True))
    B = 4096
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((0.15 * rng.normal(size=(B, 4))).astype(np.float32))
    var1 = fmpc_variable_reset(100, p.state_dim, p.input_dim, p.ineq_dim,
                               dtype=jnp.float32)
    vars_b = _jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), var1)
    epss = jnp.full((B,), 1e-4, jnp.float32)
    dt = _timeit(lambda: solver.solve_batch(jnp.float32(0.0), x0s, vars_b,
                                            epss), n=16)
    return {"metric": "fmpc_cartpole_serving_solves_per_s",
            "value": round(B / dt, 1), "unit": "solves/s",
            "vs_baseline": None}


def bench_cgmres_damper():
    """Config #5: C/GMRES continuation, semiactive damper, batched
    controllers (vmap over initial conditions)."""
    import jax as _jax
    from nmpc_tpu import CgmresConfig, CgmresSolver
    from nmpc_tpu.models.damper import make_damper_problem
    from nmpc_tpu.solvers.cgmres import _control_step_bm

    import functools
    problem = make_damper_problem()
    config = CgmresConfig()
    solver = CgmresSolver(problem, config)
    state = solver.setup()
    B = 512
    rng = np.random.default_rng(0)
    xs = jnp.asarray((np.tile([2.0, 0.0], (B, 1))
                      + 0.1 * rng.normal(size=(B, 2))).astype(np.float32))
    states = _jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a.astype(jnp.float32), (B,) + a.shape),
        state)
    # lane-blocked batch-minor fleet kernel
    step = _jax.jit(functools.partial(_control_step_bm, problem, config))
    next_xs = xs  # one-step continuation benchmark
    dt = _timeit(lambda: step(jnp.float32(0.1), xs, next_xs, states), n=256)
    return {"metric": "cgmres_damper_control_steps_per_s",
            "value": round(B / dt, 1), "unit": "steps/s",
            "vs_baseline": round((B / dt) / 1000.0, 3)}  # ref budget: 1 kHz


def bench_cgmres_fleet_closed_loop():
    """Closed-loop fleet simulation: 512 damper controllers, 100 control
    steps each, fully on device.  ``simulate_batch`` scans the
    lane-blocked ``_control_step_bm_core`` (one boundary transpose outside
    the scan); vmap-of-single ``_simulate`` is timed beside it."""
    import jax as _jax
    from nmpc_tpu import CgmresConfig, CgmresSolver
    from nmpc_tpu.models.damper import make_damper_problem

    problem = make_damper_problem()
    config = CgmresConfig()
    solver = CgmresSolver(problem, config)
    state = solver.setup()
    B, n_steps = 512, 100
    rng = np.random.default_rng(0)
    # offsets of 0.1 from the shared warm start diverge on ~5% of lanes
    xs = jnp.asarray((np.tile([2.0, 0.0], (B, 1))
                      + 0.03 * rng.normal(size=(B, 2))).astype(np.float32))
    states = _jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a.astype(jnp.float32), (B,) + a.shape),
        state)
    t0 = jnp.float32(0.0)
    dt_bm = _timeit(lambda: solver.simulate_batch(t0, xs, states, n_steps),
                    n=8)
    dt_vm = _timeit(lambda: solver._sim_batch_vmap(t0, xs, states, n_steps),
                    n=8)
    steps_per_s = B * n_steps / dt_bm
    return {"metric": "cgmres_fleet_closed_loop_steps_per_s",
            "value": round(steps_per_s, 1), "unit": "ctrl-steps/s",
            "vs_baseline": round(steps_per_s / 1000.0, 3),  # ref: 1 kHz tick
            "speedup_vs_vmap_of_single": round(dt_vm / dt_bm, 2)}


def bench_p99_latency():
    """p99 per-MPC-tick latency vs the 4 ms cart-pole budget
    (``TestDDPCartPole.cpp:302``: mpc_dt = 4 ms, max_iter = 3, horizon 200).

    Measured as the per-step time of the fully on-device closed loop with
    256 simultaneous controllers: each tick = one warm-started 3-iteration
    solve + plant step + warm-start shift for every controller.  Each of
    20 fenced 50-tick runs gives one per-tick sample.
    """
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.mpc.closed_loop import make_closed_loop_batch

    problem = make_cartpole_problem(0.01)
    solver = DDPSolver(problem, DDPConfig(horizon_steps=200, max_iter=3))
    B, n_steps = 256, 50
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us0 = jnp.zeros((B, 200, 1), jnp.float32)
    sim = make_closed_loop_batch(solver, n_steps=n_steps)
    jax.block_until_ready(sim(jnp.float32(0.0), x0s, us0))  # compile
    reps = []
    for _ in range(20):
        start = time.perf_counter()
        jax.block_until_ready(sim(jnp.float32(0.0), x0s, us0))
        reps.append((time.perf_counter() - start) / n_steps * 1e3)
    p99 = float(np.percentile(reps, 99))
    return {"metric": "mpc_tick_latency_p99_256_controllers",
            "value": round(p99, 3), "unit": "ms/tick",
            "vs_baseline": round(4.0 / p99, 3)}  # budget 4 ms / achieved


def bench_parallel_riccati():
    """Long-horizon parallel-in-time Riccati vs sequential scan (N=2048)."""
    from nmpc_tpu.solvers.parallel_riccati import (LQRStage,
                                                   solve_lqr_parallel,
                                                   solve_lqr_sequential)

    N, nx, nu = 2048, 8, 2
    rng = np.random.default_rng(0)
    A = jnp.asarray((0.3 * rng.normal(size=(N, nx, nx))
                     + np.eye(nx)).astype(np.float32))
    B_ = jnp.asarray(0.3 * rng.normal(size=(N, nx, nu)).astype(np.float32))
    W = 0.3 * rng.normal(size=(N, nx, nx))
    Qxx = jnp.asarray((W @ W.transpose(0, 2, 1)
                       + 0.5 * np.eye(nx)).astype(np.float32))
    Quu = jnp.asarray(np.tile(np.eye(nu, dtype=np.float32), (N, 1, 1)))
    stage = LQRStage(A, B_, jnp.zeros((N, nx), jnp.float32), Qxx, Quu,
                     jnp.zeros((N, nu, nx), jnp.float32),
                     jnp.zeros((N, nx), jnp.float32),
                     jnp.zeros((N, nu), jnp.float32))
    S_T = jnp.eye(nx, dtype=jnp.float32)
    f_par = jax.jit(lambda: solve_lqr_parallel(stage, S_T)[0])
    f_seq = jax.jit(lambda: solve_lqr_sequential(stage, S_T)[0])
    dt_par = _timeit(f_par)
    dt_seq = _timeit(f_seq)
    return {"metric": "parallel_riccati_speedup_N2048",
            "value": round(dt_seq / dt_par, 2), "unit": "x vs sequential",
            "vs_baseline": None,
            "detail": {"parallel_ms": round(dt_par * 1e3, 2),
                       "sequential_ms": round(dt_seq * 1e3, 2),
                       "note": "informational: O(log N) depth vs O(N) "
                               "at a ~Nx work multiplier of flow "
                               "composition"}}


ALL = [bench_ddp_cartpole, bench_ddp_bipedal, bench_boxed_ddp_vertical,
       bench_boxed_ddp_centroidal,
       bench_fmpc_oscillator, bench_fmpc_cartpole_serving,
       bench_cgmres_damper,
       bench_cgmres_fleet_closed_loop, bench_p99_latency,
       bench_parallel_riccati]


def main():
    from nmpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_all measures the GPU; JAX found {dev.platform!r}")
    names = sys.argv[1:]
    failed = []
    with jax.default_matmul_precision("highest"):
        for fn in ALL:
            if names and fn.__name__ not in names:
                continue
            try:
                row = fn()
            except Exception:  # noqa: BLE001 — report, then fail the run
                failed.append(fn.__name__)
                row = {"metric": fn.__name__,
                       "error": traceback.format_exc()[-1500:]}
            row["device_kind"] = dev.device_kind
            print(json.dumps(row), flush=True)
    if failed:
        sys.exit(f"bench_all: rows failed: {failed}")


if __name__ == "__main__":
    main()
