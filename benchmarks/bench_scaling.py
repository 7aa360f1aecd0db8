"""Scaling-efficiency benchmark: solves/s per device as the mesh grows.

BASELINE target: >= 80% solves/s scaling efficiency from one card to
four (batch sharded over the cards).  The workload is embarrassingly
parallel over the batch (no cross-lane collectives inside the solve; only
the final convergence-stats psum), so the measured efficiency reflects
sharding overhead rather than communication volume.  Weak scaling: a
fixed batch per device.  One JSON line per mesh size; run on the cards
(one process drives all of them):  python benchmarks/bench_scaling.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def measure(n_devices: int, per_device_batch: int = 512, horizon: int = 50,
            max_iter: int = 5):
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.parallel.mesh import make_mesh, make_sharded_solve, shard_batch

    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=horizon, max_iter=max_iter))
    devices = jax.devices()[:n_devices]
    mesh = make_mesh(devices=devices)
    B = per_device_batch * n_devices
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us0 = jnp.zeros((B, horizon, 1), jnp.float32)
    x0s, us0 = shard_batch(mesh, (x0s, us0))
    solve = make_sharded_solve(solver, mesh)
    jax.block_until_ready(solve(jnp.float32(0.0), x0s, us0))
    n_rep = 5
    start = time.perf_counter()
    for _ in range(n_rep):
        out = solve(jnp.float32(0.0), x0s, us0)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - start) / n_rep
    return B / dt


def main():
    from nmpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    n_all = len(jax.devices())
    base = measure(1)
    print(json.dumps({"metric": "scaling_solves_per_s_1dev",
                      "value": round(base, 1), "unit": "solves/s",
                      "devices": 1, "efficiency": 1.0}), flush=True)
    n = 2
    while n <= n_all:
        rate = measure(n)
        eff = rate / (base * n)
        print(json.dumps({"metric": f"scaling_solves_per_s_{n}dev",
                          "value": round(rate, 1), "unit": "solves/s",
                          "devices": n, "efficiency": round(eff, 3)}),
              flush=True)
        n *= 2


if __name__ == "__main__":
    main()
