"""Example: cart-pole swing-up with DDP — single solve and closed-loop MPC.

Run:  python examples/swingup.py        (GPU or CPU)
"""

import sys

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from nmpc_tpu import DDPConfig, DDPSolver, DDPStatus
from nmpc_tpu.models.cartpole import make_cartpole_problem
from nmpc_tpu.mpc.driver import run_mpc
from nmpc_tpu.utils.trace import dump_ddp_trace


def main():
    problem = make_cartpole_problem(dt=0.01, input_limits=(-15.0, 15.0))
    config = DDPConfig(horizon_steps=100, max_iter=50,
                       with_input_constraint=True)
    solver = DDPSolver(problem, config)

    # one solve from the hanging pose
    x0 = jnp.array([0.0, np.pi, 0.0, 0.0])
    res = solver.solve(0.0, x0, jnp.zeros((100, 1)))
    print(f"single solve: {DDPStatus(int(res.status)).name} in "
          f"{int(res.iters)} iterations, cost {float(jnp.sum(res.costs)):.3f}, "
          f"|u|max {float(jnp.abs(res.us).max()):.2f} N")
    dump_ddp_trace(res, "/tmp/swingup_trace.txt")
    print("trace table: /tmp/swingup_trace.txt")

    # closed-loop MPC (reference pattern: solve, apply u0, shift warm start)
    mpc_solver = DDPSolver(problem, DDPConfig(horizon_steps=200, max_iter=3,
                                              with_input_constraint=True))
    log = run_mpc(mpc_solver, x0, end_t=5.0)
    xf = log.xs[-1]
    print(f"after 5 s MPC: theta={xf[1]:+.3f} rad, omega={xf[3]:+.3f} rad/s, "
          f"mean solve {log.solve_wall_ms.mean():.1f} ms")


if __name__ == "__main__":
    main()
