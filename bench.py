"""Benchmark: batched cart-pole DDP solves/s on one GPU.

BASELINE.md target: >= 10,000 batched DDP cart-pole solves/s
(state 4, input 1, horizon 100), u-trajectories matching the reference
algorithm (golden parity is enforced in tests/).

Before timing, the kernel parity gate (benchmarks/parity_gate.py) runs
every fused kernel against its XLA twin at the served widths; a failed
gate prints no number and exits non-zero.  Timing: warm-up, then the
median of ``block_until_ready``-fenced solves (benchmarks/timing.py).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import sys

import numpy as np

BASELINE_SOLVES_PER_S = 10_000.0


def main():
    import jax
    import jax.numpy as jnp

    from benchmarks.parity_gate import kernel_checks
    from benchmarks.timing import time_call
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    parity = kernel_checks()
    if not all(v["pass"] for v in parity.values()):
        print(json.dumps({
            "metric": "ddp_cartpole_solves_per_s",
            "error": "parity gate FAILED — headline refused",
            "parity": parity,
        }))
        raise SystemExit(1)

    # BASELINE.json config #1: cart-pole swing-up, horizon 100.
    problem = make_cartpole_problem(0.01)
    config = DDPConfig(horizon_steps=100, max_iter=10)
    solver = DDPSolver(problem, config)

    B = 4096
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        (np.tile(np.array([0.0, np.pi, 0.0, 0.0]), (B, 1))
         + 0.05 * rng.normal(size=(B, 4))).astype(np.float32)
    )
    us0 = jnp.zeros((B, 100, 1), jnp.float32)
    t0 = jnp.float32(0.0)

    t = time_call(solver.solve_batch, t0, x0s, us0, reps=30)
    solves_per_s = B / t["median"]
    print(json.dumps({
        "metric": "ddp_cartpole_solves_per_s",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / BASELINE_SOLVES_PER_S,
        "median_ms": t["median"] * 1e3, "q1_ms": t["q1"] * 1e3,
        "q3_ms": t["q3"] * 1e3, "n": t["n"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "parity_max_err": max(v["max_err"] for v in parity.values()),
    }))


if __name__ == "__main__":
    main()
