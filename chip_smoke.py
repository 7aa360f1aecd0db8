"""Smoke test of the batched NMPC solvers on one GPU (or four, ``--four``).

Runs each solver family once through the entry points a user calls, at
the widths the repository benchmarks, and checks the result on the card:

1. DDP cart-pole, B=4096, N=100, 10 iterations, fp32, ``auto`` (the fused
   kernels) against the same call forced to stacked/scan; eight lanes
   also against the fp64 NumPy golden solver.
2. Boxed DDP vertical motion, B=1024, N=100: the same comparison, and u
   inside the box.
3. FMPC cart-pole serving shape (N=100, ng=4, B=4096) against the stacked
   path (converged set equal, converged u within tolerance); FMPC
   oscillator at B=1024 likewise.
4. C/GMRES semiactive-damper fleet, 512 controllers, on-device closed
   loop, against the same code on the CPU for the first lanes.
5. DDP tick loop (mpc/closed_loop.py), 256 controllers, N=200,
   3 iterations: finite outputs and per-lane status.
6. Kernel parity: every kernel against its XLA twin at the widths above
   (benchmarks/parity_gate.py).

``--four`` runs, on four cards and nothing else: the dp-sharded batch
solve on a (dp=4, sp=1) mesh against the same batch on one card, and the
horizon-sharded Riccati on (dp=2, sp=2) against the sequential Riccati
recursion on one card.

Any failed phase raises (non-zero exit, no result line).  The last line
of standard output is one JSON object naming the device.  Run from the
repository root:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np


# Per-phase time limits (s), several times each phase's compile + run on
# an H100 with an empty compile cache; the run as a whole stays inside
# RUN_LIMIT.  A phase past its limit prints every thread's stack and exits
# non-zero instead of holding the cards.
RUN_LIMIT = {"one": 1150.0, "four": 420.0}
PHASE_LIMIT = {"start": 120, "phase_ddp_cartpole": 240, "phase_ddp_boxed": 300,
               "phase_fmpc": 240, "phase_cgmres": 120, "phase_tick": 120,
               "phase_kernels": 480, "four_dp_solve": 180, "four_psum": 60,
               "four_riccati": 150}
_deadline = None


@contextlib.contextmanager
def _watchdog(name):
    left = _deadline - time.perf_counter()
    faulthandler.dump_traceback_later(max(1.0, min(PHASE_LIMIT[name], left)),
                                      exit=True)
    t = time.perf_counter()
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
    print(f"  ({name}: {time.perf_counter() - t:.1f} s)", flush=True)


def _devices_or_exit(count):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU: JAX found {devs[0].platform!r} "
                 f"devices; this check has no CPU fallback")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found {len(devs)}")
    return devs


def _say(phase, ok, **info):
    print(f"phase {phase}: {'ok' if ok else 'FAILED'} "
          + json.dumps(info, default=float), flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: phase {phase} failed")


def phase_ddp_cartpole():
    import jax.numpy as jnp
    from benchmarks import parity_gate as G
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from golden.cartpole_numpy import CartPoleGolden
    from golden.ddp_numpy import GoldenConfig, GoldenDDP

    res = G._e2e_ddp_unconstrained()
    _say("1 ddp_cartpole B=4096 N=100 auto-vs-stacked", res["pass"], **res)

    # fp64 golden, 8 lanes through the kernel path at convergence: the
    # fp32 solve's u is conditioning-limited (Quu ~ 0.02 maps fp32 cost
    # noise to ~1e-3 relative u in the flat optimal valley,
    # tests/test_fp32_parity.py; 1.4e-3 on the CPU's stacked path), so u
    # is bounded at 5e-3 relative; the cost agrees to 1e-5 relative.
    B, N = 8, 100
    rng = np.random.default_rng(3)
    x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
           + 0.02 * rng.normal(size=(B, 4)))
    config = DDPConfig(horizon_steps=N, max_iter=50).for_fp32()
    r = DDPSolver(make_cartpole_problem(0.01), config).solve_batch(
        jnp.float32(0.0), jnp.asarray(x0s, jnp.float32),
        jnp.zeros((B, N, 1), jnp.float32))
    golden = GoldenDDP(CartPoleGolden(0.01),
                       GoldenConfig(horizon_steps=N, max_iter=50))
    du, dc, n_ok = 0.0, 0.0, 0
    for b in range(B):
        g = golden.solve(0.0, x0s[b], np.zeros((N, 1)))
        n_ok += int(g["status"] == "succeeded" and int(r.status[b]) == 1)
        u64 = g["us"][:, 0]
        du = max(du, float(np.abs(np.asarray(r.us[b, :, 0]) - u64).max()
                           / np.abs(u64).max()))
        c64 = float(g["costs"].sum())
        dc = max(dc, abs(float(jnp.sum(r.costs[b])) - c64) / c64)
    _say("1 ddp_cartpole 8 lanes vs fp64 golden", n_ok == B and du < 5e-3
         and dc < 1e-5, lanes_converged=n_ok, u_rel_err=du, u_tol=5e-3,
         cost_rel_err=dc, cost_tol=1e-5)


def phase_ddp_boxed():
    import jax
    import jax.numpy as jnp
    from benchmarks import parity_gate as G
    from nmpc_tpu import DDPConfig, DDPSolver, DDPStatus
    from nmpc_tpu.models.vertical import make_vertical_problem

    res = G._e2e_ddp_boxed()
    _say("2 ddp_boxed_vertical B=1024 N=100 auto-vs-stacked", res["pass"],
         **res)

    # at convergence the active inputs lie in the box [0, 30] (an
    # intermediate iterate need not: the line search's K dx term is not
    # clamped, as in the reference); inactive inputs carry no force
    p = make_vertical_problem(0.01)
    B, N = 1024, 100
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    c = DDPConfig(horizon_steps=N, max_iter=30, initial_lambda=1e-6,
                  with_input_constraint=True)
    r = DDPSolver(p, c).solve_batch(jnp.float32(0.0), x0s,
                                    jnp.zeros((B, N, 2), jnp.float32))
    mask = np.asarray(jax.vmap(p.input_mask_at)(
        jnp.float32(0.01) * jnp.arange(N, dtype=jnp.float32)))
    us = np.asarray(r.us)
    act = np.broadcast_to(mask[None] > 0, us.shape)
    lo, hi = (float(v[0]) for v in p.input_limits(0.0))
    n_conv = int((np.asarray(r.status) == int(DDPStatus.SUCCEEDED)).sum())
    in_box = bool((us[act] >= lo - 1e-5).all() and (us[act] <= hi + 1e-5).all())
    _say("2 ddp_boxed_vertical converged u in box", n_conv == B and in_box,
         n_converged=n_conv, u_active_min=float(us[act].min()),
         u_active_max=float(us[act].max()), box=[lo, hi],
         u_inactive_absmax=float(np.abs(us[~act]).max()))


def phase_fmpc():
    from benchmarks import parity_gate as G

    res = G._e2e_fmpc()
    _say("3 fmpc_cartpole N=100 ng=4 B=4096 auto-vs-stacked", res["pass"],
         **res)
    res = _fmpc_oscillator()
    _say("3 fmpc_oscillator N=100 B=1024 auto-vs-stacked", res["pass"],
         **res)


def _fmpc_oscillator(B=1024, N=100):
    import jax
    import jax.numpy as jnp
    from benchmarks.parity_gate import TOL_E2E_FMPC_U
    from nmpc_tpu import FmpcConfig, FmpcSolver, FmpcStatus
    from nmpc_tpu import fmpc_variable_reset
    from nmpc_tpu.models.oscillator import make_oscillator_problem

    p = make_oscillator_problem(0.01)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, 1.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(np.float32))
    var = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape),
        fmpc_variable_reset(N, 2, 1, 3, dtype=jnp.float32))
    eps = jnp.full((B,), 1e-4, jnp.float32)
    out = {}
    for bw, fw in (("auto", "auto"), ("stacked", "scan")):
        c = FmpcConfig(horizon_steps=N, max_iter=20, kkt_error_thre=1e-2,
                       init_complementary_variable=True, backward_impl=bw,
                       forward_impl=fw)
        out[bw] = FmpcSolver(p, c).solve_batch(jnp.float32(0.0), x0s, var,
                                               eps)
    ca = np.asarray(out["auto"].status) == int(FmpcStatus.SUCCEEDED)
    cb = np.asarray(out["stacked"].status) == int(FmpcStatus.SUCCEEDED)
    n = int(ca.sum())
    du = (float(np.abs(np.asarray(out["auto"].variable.us)[ca]
                       - np.asarray(out["stacked"].variable.us)[ca]).max())
          if n else float("nan"))
    finite = bool(np.isfinite(np.asarray(out["auto"].variable.us)).all())
    return {"converged_set_equal": bool(np.array_equal(ca, cb)),
            "n_converged": n, "u_max_diff_converged": du,
            "tol": TOL_E2E_FMPC_U, "finite": finite,
            "pass": bool(np.array_equal(ca, cb) and n >= B // 4
                         and du <= TOL_E2E_FMPC_U and finite)}


def phase_cgmres():
    import jax
    import jax.numpy as jnp
    from nmpc_tpu import CgmresConfig, CgmresSolver
    from nmpc_tpu.models.damper import make_damper_problem

    solver = CgmresSolver(make_damper_problem(), CgmresConfig())
    state = solver.setup()
    B, n_steps, n_cpu = 512, 100, 8
    rng = np.random.default_rng(0)
    # every controller warm-starts from the continuation state set up at
    # (2, 0); offsets of 0.1 from it diverge on ~5% of lanes (on the CPU
    # too), so the fleet starts within 0.03
    xs = (np.tile([2.0, 0.0], (B, 1))
          + 0.03 * rng.normal(size=(B, 2))).astype(np.float32)
    states = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a.astype(jnp.float32), (B,) + a.shape),
        state)
    t0 = jnp.float32(0.0)
    _, xg, ug, eg = solver.simulate_batch(t0, jnp.asarray(xs), states,
                                          n_steps)
    cpu = jax.devices("cpu")[0]
    put = lambda a: jax.device_put(a, cpu)
    _, xc, uc, _ = solver.simulate_batch(
        put(t0), put(jnp.asarray(xs[:n_cpu])),
        jax.tree_util.tree_map(lambda a: put(a[:n_cpu]), states), n_steps)
    xg, ug = np.asarray(xg), np.asarray(ug)
    # same fp32 program on two backends: reductions (GMRES inner products)
    # sum in another order, and 100 continuation steps carry the
    # difference, so states agree to ~1e-5 relative, bounded at 1e-3
    dx = float(np.abs(xg[:n_cpu] - np.asarray(xc)).max()
               / (1.0 + np.abs(np.asarray(xc)).max()))
    du = float(np.abs(ug[:n_cpu] - np.asarray(uc)).max()
               / (1.0 + np.abs(np.asarray(uc)).max()))
    finite = bool(np.isfinite(xg).all() and np.isfinite(ug).all())
    settled = float(np.abs(xg[:, -1]).max())
    _say("4 cgmres_damper_fleet B=512 closed loop, gpu-vs-cpu",
         finite and dx < 1e-3 and du < 1e-3, x_rel_err=dx, u_rel_err=du,
         tol=1e-3, finite=finite, max_abs_final_state=settled)


def phase_tick():
    import jax.numpy as jnp
    from nmpc_tpu import DDPConfig, DDPSolver, DDPStatus
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.mpc.closed_loop import make_closed_loop_batch

    B, N, n_steps = 256, 200, 20
    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=N, max_iter=3))
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    log = make_closed_loop_batch(solver, n_steps=n_steps)(
        jnp.float32(0.0), x0s, jnp.zeros((B, N, 1), jnp.float32))
    st = np.asarray(log.status)
    finite = bool(np.isfinite(np.asarray(log.xs)).all()
                  and np.isfinite(np.asarray(log.us)).all())
    valid = bool(np.isin(st, [int(s) for s in DDPStatus]).all()
                 and (st != int(DDPStatus.RUNNING)).all())
    counts = {DDPStatus(s).name: int((st[:, -1] == s).sum())
              for s in np.unique(st[:, -1])}
    _say("5 ddp_tick_loop B=256 N=200 3 iters x 20 ticks", finite and valid,
         finite=finite, status_shape=list(st.shape),
         final_status_counts=counts)


def phase_kernels():
    from benchmarks import parity_gate as G

    res = G.kernel_checks()
    for name, r in res.items():
        _say(f"6 kernel {name}", r["pass"], max_err=r["max_err"],
             tol=r["tol"])


def four_cards():
    import jax
    import jax.numpy as jnp
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.parallel.horizon import solve_lqr_horizon_sharded
    from nmpc_tpu.parallel.mesh import (convergence_stats, make_mesh,
                                        make_sharded_solve, shard_batch)
    from nmpc_tpu.solvers.parallel_riccati import (LQRStage,
                                                   solve_lqr_sequential)

    devs = jax.devices()[:4]
    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=100, max_iter=10))
    B, N = 4096, 100
    rng = np.random.default_rng(0)
    # even lanes swing up from hanging (they hit max_iter), odd lanes
    # stabilise near upright (they converge), so the success rate is
    # neither 0 nor 1
    hang = (np.arange(B) % 2 == 0)[:, None]
    x0s = jnp.asarray((np.where(hang, [0.0, np.pi, 0.0, 0.0], 0.0)
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us0 = jnp.zeros((B, N, 1), jnp.float32)
    with _watchdog("four_dp_solve"):
        one = jax.device_put((jnp.float32(0.0), x0s, us0), devs[0])
        ref = solver.solve_batch(*one)
        mesh = make_mesh(devices=devs, dp=4, sp=1)
        xs_sh, us_sh = shard_batch(mesh, (x0s, us0))
        res = make_sharded_solve(solver, mesh)(jnp.float32(0.0), xs_sh,
                                               us_sh)
        du = float(np.abs(np.asarray(res.us) - np.asarray(ref.us)).max())
        st = bool(np.array_equal(np.asarray(res.status),
                                 np.asarray(ref.status)))
        it = bool(np.array_equal(np.asarray(res.iters),
                                 np.asarray(ref.iters)))
    # the per-lane program is identical on every card, so sharding the
    # batch must not change a bit
    _say("four dp=4 sharded solve B=4096 vs one card", st and it and du == 0,
         status_equal=st, iters_equal=it, us_max_diff=du,
         shards=len(res.us.sharding.device_set))
    # the first collective across the cards: psum of per-shard counts
    with _watchdog("four_psum"):
        stats = convergence_stats(mesh, res)
        n = float(stats["n"])
        rate = float(stats["success_rate"])
        iters = float(stats["mean_iters"])
    ref_st = np.asarray(ref.status)
    ref_rate = float(np.mean(ref_st == 1))
    ref_iters = float(np.mean(np.asarray(ref.iters)))
    _say("four dp=4 psum convergence stats",
         n == B and 0.0 < rate < 1.0 and rate == ref_rate
         and abs(iters - ref_iters) <= 1e-6 * ref_iters,
         n=n, success_rate=rate, one_card_success_rate=ref_rate,
         mean_iters=iters, one_card_mean_iters=ref_iters)

    N, nx, nu = 256, 8, 2
    W = rng.normal(size=(N, nx, nx)).astype(np.float32) * 0.3
    Wu = rng.normal(size=(N, nu, nu)).astype(np.float32) * 0.3
    stage = LQRStage(
        A=jnp.asarray(W + np.eye(nx, dtype=np.float32)),
        B=jnp.asarray(rng.normal(size=(N, nx, nu)).astype(np.float32) * 0.3),
        c=jnp.zeros((N, nx), jnp.float32),
        Qxx=jnp.asarray(W @ W.transpose(0, 2, 1)
                        + 0.5 * np.eye(nx, dtype=np.float32)),
        Quu=jnp.asarray(Wu @ Wu.transpose(0, 2, 1)
                        + np.eye(nu, dtype=np.float32)),
        Qux=jnp.zeros((N, nu, nx), jnp.float32),
        q=jnp.asarray(rng.normal(size=(N, nx)).astype(np.float32) * 0.1),
        r=jnp.asarray(rng.normal(size=(N, nu)).astype(np.float32) * 0.1),
    )
    S_T = jnp.eye(nx, dtype=jnp.float32)
    mesh2 = make_mesh(devices=devs, dp=2, sp=2)
    # reference: the sequential O(N) recursion on one card, which both
    # parallel forms are tested against (tests/test_parallel_riccati.py);
    # the one-device associative-scan form takes minutes to compile at
    # N=256.  The flow composition reorders fp32 products, so gains agree
    # to ~5e-6 relative, bounded at 1e-4.
    with _watchdog("four_riccati"), \
            jax.default_matmul_precision("highest"):
        Ks, ks, _ = jax.jit(lambda st_: solve_lqr_horizon_sharded(
            st_, S_T, mesh=mesh2))(stage)
        Ks1, ks1 = jax.jit(lambda st_: solve_lqr_sequential(st_, S_T))(
            jax.device_put(stage, devs[0]))
        Ks, ks = jax.block_until_ready((Ks, ks))
        Ks1, ks1 = jax.block_until_ready((Ks1, ks1))
    rel = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                             / (1.0 + np.abs(np.asarray(b)).max()))
    err = max(rel(Ks, Ks1), rel(ks, ks1))
    _say("four sp=2 horizon-sharded Riccati N=256 vs one card", err <= 1e-4,
         max_err=err, tol=1e-4)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    a = ap.parse_args()
    global _deadline
    start = time.perf_counter()
    _deadline = start + RUN_LIMIT["four" if a.four else "one"]
    with _watchdog("start"):
        devs = _devices_or_exit(4 if a.four else 1)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        print(smi.stdout.strip(), flush=True)
        print(devs, flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nmpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if a.four:
        four_cards()
    else:
        for phase in (phase_ddp_cartpole, phase_ddp_boxed, phase_fmpc,
                      phase_cgmres, phase_tick, phase_kernels):
            with _watchdog(phase.__name__):
                phase()
    print(f"total {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
