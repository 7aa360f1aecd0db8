"""Kernel-versus-XLA A/B, end to end in the solve, on the GPU.

Every hand-written kernel has a plain XLA twin selected by the same
config field (``backward_impl`` / ``forward_impl``).  This script times
full ``solve_batch`` calls with each combination at the shapes the
``auto`` rules serve, so a kernel stays only where it wins end to end:

* ``ddp_cartpole``   — DDP cart-pole, B=4096, N=100, 10 iterations;
* ``ddp_tick``       — DDP cart-pole tick shape, B=256, N=200, 3 iterations;
* ``ddp_boxed``      — boxed DDP vertical motion, B=1024, N=100, 3 iterations;
* ``ddp_boxed_wide`` — boxed DDP at a wide input, where ``auto`` keeps the
  stacked backward: a point mass pushed along nu=8 fixed directions,
  B=256, N=100, 3 iterations (on an H100 the kernel's solve had not
  compiled after 7 minutes; run this row under a time limit);
* ``fmpc_cartpole``  — FMPC cart-pole, N=100, ng=4, B=4096, 5 iterations;
* ``fmpc_oscillator``— FMPC oscillator, N=100, B=1024, 5 iterations;
* ``kernel_times``   — each kernel alone against its XLA twin, one call on
  first-iteration data at the served widths;
* ``block_sweep``    — the DDP backward kernel alone at several
  (BLOCK, num_warps) choices.

Run on the GPU from the repo root (one process):

    python benchmarks/bench_kernels.py [row ...] [--out FILE]

Prints one JSON line per measurement (median, quartiles and count of
``block_until_ready``-fenced calls) and appends it to ``--out``.
Exits non-zero if any row failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.timing import time_call  # noqa: E402
from nmpc_tpu.utils.cache import enable_compilation_cache  # noqa: E402

DDP_IMPLS = (("stacked", "scan"), ("pallas", "scan"), ("stacked", "fused"),
             ("pallas", "fused"), ("remat", "scan"), ("remat", "fused"))
FMPC_IMPLS = (("stacked", "scan"), ("pallas", "scan"), ("stacked", "fused"),
              ("pallas", "fused"))


def _ddp_inputs(model, B, N):
    rng = np.random.default_rng(0)
    if model == "cartpole":
        x0 = np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
        x0s = x0 + 0.05 * rng.normal(size=(B, 4))
        nu = 1
    else:
        x0s = np.tile([1.2, 0.0], (B, 1)) + 0.05 * rng.normal(size=(B, 2))
        nu = 2
    return (jnp.float32(0.0), jnp.asarray(x0s.astype(np.float32)),
            jnp.zeros((B, N, nu), jnp.float32))


def _ddp_row(cell, model, B, N, max_iter, impls, reps):
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.models.vertical import make_vertical_problem

    if model == "cartpole":
        problem = make_cartpole_problem(0.01)
        base = DDPConfig(horizon_steps=N, max_iter=max_iter)
    else:
        problem = make_vertical_problem(0.01)
        base = DDPConfig(horizon_steps=N, max_iter=max_iter,
                         initial_lambda=1e-6, with_input_constraint=True)
    args = _ddp_inputs(model, B, N)
    for bw, fw in impls:
        solver = DDPSolver(problem, dataclasses.replace(
            base, backward_impl=bw, forward_impl=fw))
        yield _measure(cell, f"{bw}/{fw}", B, solver.solve_batch, args, reps)


def _pushed_mass_problem(nu, dt=0.03):
    """Boxed point mass (x = [position, velocity] in 3-D) pushed by nu
    forces 0 <= u <= 1000 along fixed directions: the centroidal model's
    input structure (models/centroidal.py, nu=16) at another width."""
    from nmpc_tpu.core.problem import Problem

    rng = np.random.default_rng(nu)
    dirs = rng.normal(size=(nu, 3)) + [0.0, 0.0, 2.0]
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=1, keepdims=True),
                       jnp.float32)
    mass, g = 10.0, jnp.asarray([0.0, 0.0, 9.8], jnp.float32)
    ref = jnp.asarray([0.0, 0.0, 1.0, 0.0, 0.0, 0.0], jnp.float32)

    def dynamics(t, x, u):
        acc = jnp.sum(u[:, None] * dirs.astype(x.dtype), axis=0) / mass - g
        return x + dt * jnp.concatenate([x[3:], acc])

    def running_cost(t, x, u):
        return 0.5 * jnp.sum((x - ref) ** 2) + 0.5e-6 * jnp.sum(u ** 2)

    def terminal_cost(t, x):
        return 0.5 * jnp.sum((x - ref) ** 2)

    return Problem(dt=dt, state_dim=6, input_dim=nu, dynamics=dynamics,
                   running_cost=running_cost, terminal_cost=terminal_cost,
                   input_limits=lambda t: (jnp.zeros((nu,)),
                                           jnp.full((nu,), 1000.0)))


def _ddp_wide_row(reps, B=256, N=100, max_iter=3, nu=8):
    """Boxed DDP at a wide input: stacked against the fused boxed kernel
    (the rollout as ``auto`` picks it)."""
    from nmpc_tpu import DDPConfig, DDPSolver

    problem = _pushed_mass_problem(nu)
    rng = np.random.default_rng(0)
    x0 = np.zeros(6)
    x0[2] = 1.0
    args = (jnp.float32(0.0),
            jnp.asarray((x0 + 0.02 * rng.normal(size=(B, 6)))
                        .astype(np.float32)),
            jnp.full((B, N, nu), 5.0, jnp.float32))
    for bw in ("stacked", "pallas"):
        c = DDPConfig(horizon_steps=N, max_iter=max_iter, initial_lambda=1e-6,
                      with_input_constraint=True, backward_impl=bw)
        yield _measure(f"ddp_boxed_wide/pushed_mass_nu{nu}", f"{bw}/auto", B,
                       DDPSolver(problem, c).solve_batch, args, reps)


def _fmpc_row(cell, model, B, N, max_iter, impls, reps):
    from nmpc_tpu import FmpcConfig, FmpcSolver, fmpc_variable_reset
    from nmpc_tpu.models.cartpole import make_cartpole_fmpc_problem
    from nmpc_tpu.models.oscillator import make_oscillator_problem

    rng = np.random.default_rng(0)
    if model == "cartpole":
        p = make_cartpole_fmpc_problem(0.01)
        x0s = 0.15 * rng.normal(size=(B, 4))
    else:
        p = make_oscillator_problem(0.01)
        x0s = np.tile([0.0, 1.0], (B, 1)) + 0.05 * rng.normal(size=(B, 2))
    var1 = fmpc_variable_reset(N, p.state_dim, p.input_dim, p.ineq_dim,
                               dtype=jnp.float32)
    vars_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), var1)
    args = (jnp.float32(0.0), jnp.asarray(x0s.astype(np.float32)), vars_b,
            jnp.full((B,), 1e-4, jnp.float32))
    for bw, fw in impls:
        # kkt_error_thre=0 pins fixed work (every lane runs max_iter)
        c = FmpcConfig(horizon_steps=N, max_iter=max_iter, kkt_error_thre=0.0,
                       init_complementary_variable=True, backward_impl=bw,
                       forward_impl=fw)
        yield _measure(cell, f"{bw}/{fw}", B, FmpcSolver(p, c).solve_batch,
                       args, reps)


def _kernel_times(reps, B=4096, N=100, B_boxed=1024):
    """Each kernel alone against its XLA twin (jitted single calls)."""
    import functools

    from benchmarks import parity_gate as G
    from nmpc_tpu.kernels.ddp_backward import (backward_stacked,
                                               backward_stacked_boxed)
    from nmpc_tpu.kernels.ddp_backward_pallas import (backward_pallas,
                                                      backward_pallas_boxed)
    from nmpc_tpu.kernels.ddp_backward_remat import backward_remat
    from nmpc_tpu.kernels.ddp_forward_remat import forward_selected_remat
    from nmpc_tpu.kernels.fmpc_backward_pallas import backward_fmpc_pallas
    from nmpc_tpu.kernels.fmpc_forward_pallas import (
        forward_fmpc_deltas_pallas)
    from nmpc_tpu.kernels.lanes import block_lanes, lane_factors
    from nmpc_tpu.models.cartpole import make_cartpole_fmpc_problem
    from nmpc_tpu.solvers import ddp as Dmod
    from nmpc_tpu.solvers import fmpc as F

    c, S, VxT, VxxT, lam, p, t0, xs, us = G._ddp_unconstrained_case(
        B, N, with_trajectory=True)
    args = (S, VxT, VxxT, lam)
    yield _measure("kernel_times", "ddp_backward/xla", B,
                   jax.jit(lambda *a: backward_stacked(c, *a)), args, reps)
    yield _measure("kernel_times", "ddp_backward/kernel", B,
                   jax.jit(lambda *a: backward_pallas(c, *a)), args, reps)

    # remat replaces derivative sweep + backward
    Sh, Lh = lane_factors(B)
    xs_l = block_lanes(xs, -1, Sh, Lh)
    us_l = block_lanes(us, -1, Sh, Lh)
    flat = lambda a: a.reshape(a.shape[:-2] + (B,))

    def sweep_backward(xs_l, us_l, lam, backward=backward_pallas):
        D, VxT_, VxxT_ = Dmod._derivative_sweep_lanes(p, c, t0, xs_l, us_l)
        Dst = type(S)(*[flat(getattr(D, f)) for f in S._fields])
        return backward(c, Dst, flat(VxT_), flat(VxxT_), lam)

    def remat(xs_l, us_l, lam):
        VxT_, VxxT_ = Dmod._terminal_quad_lanes(p, c, t0, xs_l)
        return backward_remat(p, c, t0, flat(xs_l), flat(us_l), flat(VxT_),
                              flat(VxxT_), lam)

    yield _measure("kernel_times", "ddp_sweep+backward/xla", B, jax.jit(
        functools.partial(sweep_backward, backward=backward_stacked)),
        (xs_l, us_l, lam), reps)
    yield _measure("kernel_times", "ddp_sweep+backward/kernel", B,
                   jax.jit(sweep_backward), (xs_l, us_l, lam), reps)
    yield _measure("kernel_times", "ddp_remat/kernel", B, jax.jit(remat),
                   (xs_l, us_l, lam), reps)

    ks, Ks = backward_stacked(c, *args)[:2]
    lb = lambda a: block_lanes(a, -1, Sh, Lh)
    alpha = jnp.full((B,), 0.5, jnp.float32)
    fargs = (xs, us, ks, Ks, alpha)
    yield _measure("kernel_times", "ddp_forward/xla", B, jax.jit(
        lambda xs_, us_, ks_, Ks_, al: Dmod._forward_selected_lanes(
            p, c, t0, lb(xs_), lb(us_), lb(ks_), lb(Ks_), lb(al))),
        fargs, reps)
    yield _measure("kernel_times", "ddp_forward/kernel", B, jax.jit(
        lambda *a: forward_selected_remat(p, c, t0, *a)), fargs, reps)

    cb, Dst, bounds, VxTb, VxxTb, lamb = G._ddp_boxed_case(B_boxed, N)
    bargs = (Dst, bounds, VxTb, VxxTb, lamb)
    yield _measure("kernel_times", "ddp_backward_boxed/xla", B_boxed, jax.jit(
        lambda *a: backward_stacked_boxed(cb, *a)), bargs, reps)
    yield _measure("kernel_times", "ddp_backward_boxed/kernel", B_boxed,
                   jax.jit(lambda *a: backward_pallas_boxed(cb, *a)), bargs,
                   reps)

    pf, cf, co, var, gms, eps = G._fmpc_case(make_cartpole_fmpc_problem(0.01),
                                             B, N)
    bw_x = jax.jit(functools.partial(F._backward_bm, pf, cf, gms=gms,
                                     barrier_eps=eps))
    bw_k = jax.jit(lambda co_, ss, nus: backward_fmpc_pallas(
        pf, cf, co_, ss, nus, gms, eps))
    yield _measure("kernel_times", "fmpc_backward/xla", B,
                   lambda co_, ss, nus: bw_x(co_, ss, nus),
                   (co, var.ss, var.nus), reps)
    yield _measure("kernel_times", "fmpc_backward/kernel", B, bw_k,
                   (co, var.ss, var.nus), reps)
    fks, fKs = F._backward_bm(pf, cf, co, var.ss, var.nus, gms, eps)[:2]
    dx0 = jnp.full_like(var.xs[0], 0.01)
    fw_args = (co.A, co.B, co.x_bar, fks, fKs, dx0)

    def fw_scan(A, Bm, xb, ks_, Ks_, dx0_):
        from jax import lax
        from nmpc_tpu.kernels.ddp_backward import _mv

        def fstep(dx, inp):
            A_, Bm_, x_bar, k, K = inp
            du = _mv(K, dx) + k
            return _mv(A_, dx) + _mv(Bm_, du) + x_bar, (dx, du)

        return lax.scan(fstep, dx0_, (A, Bm, xb, ks_, Ks_))

    yield _measure("kernel_times", "fmpc_forward/xla", B, jax.jit(fw_scan),
                   fw_args, reps)
    yield _measure("kernel_times", "fmpc_forward/kernel", B,
                   jax.jit(forward_fmpc_deltas_pallas), fw_args, reps)


def _block_sweep(reps):
    """The DDP backward kernel alone at several (BLOCK, num_warps)."""
    from benchmarks.parity_gate import _ddp_unconstrained_case
    from nmpc_tpu.kernels import lane_kernel
    from nmpc_tpu.kernels.ddp_backward import backward_stacked
    from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas

    default = lane_kernel.block_config
    for B in (4096, 256):
        c, S, VxT, VxxT, lam = _ddp_unconstrained_case(B, 100)
        yield _measure("block_sweep", "stacked", B,
                       jax.jit(lambda *a: backward_stacked(c, *a)),
                       (S, VxT, VxxT, lam), reps)
        for blk in ((8, 1), (16, 1), (32, 1), (64, 2)):
            lane_kernel.block_config = lambda _B, blk=blk: blk
            try:
                yield _measure("block_sweep", f"pallas{blk}", B,
                               jax.jit(lambda *a: backward_pallas(c, *a)),
                               (S, VxT, VxxT, lam), reps)
            finally:
                lane_kernel.block_config = default


def _measure(cell, impl, B, fn, args, reps):
    t = time_call(fn, *args, reps=reps)
    return {"cell": cell, "impl": impl, "B": B,
            "median_ms": t["median"] * 1e3, "q1_ms": t["q1"] * 1e3,
            "q3_ms": t["q3"] * 1e3, "n": t["n"],
            "per_s": B / t["median"], "first_call_s": t["first"]}


ROWS = {
    "ddp_cartpole": lambda r: _ddp_row("ddp_cartpole", "cartpole", 4096, 100,
                                       10, DDP_IMPLS, r),
    "ddp_tick": lambda r: _ddp_row("ddp_tick", "cartpole", 256, 200, 3,
                                   DDP_IMPLS, r),
    "ddp_boxed": lambda r: _ddp_row("ddp_boxed", "vertical", 1024, 100, 3,
                                    DDP_IMPLS, r),
    "ddp_boxed_wide": _ddp_wide_row,
    "fmpc_cartpole": lambda r: _fmpc_row("fmpc_cartpole", "cartpole", 4096,
                                         100, 5, FMPC_IMPLS, r),
    "fmpc_oscillator": lambda r: _fmpc_row("fmpc_oscillator", "oscillator",
                                           1024, 100, 5, FMPC_IMPLS, r),
    "kernel_times": _kernel_times,
    "block_sweep": _block_sweep,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="*", default=list(ROWS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_kernels needs a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    head = {"device_kind": dev.device_kind, "nvidia_smi": smi.strip()}
    print(json.dumps(head), flush=True)
    out = open(a.out, "a") if a.out else None
    failed = False
    with jax.default_matmul_precision("highest"):
        for name in a.rows:
            try:
                for rec in ROWS[name](a.reps):
                    rec["device_kind"] = dev.device_kind
                    line = json.dumps(rec)
                    print(line, flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
            except Exception:  # noqa: BLE001 — record the row, keep going
                failed = True
                print(json.dumps({"cell": name, "error":
                                  traceback.format_exc()[-2000:]}),
                      flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
