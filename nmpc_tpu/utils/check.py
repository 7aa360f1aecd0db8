"""Derivative cross-check utilities.

The reference validates every problem's hand-written derivatives against
central finite differences (pattern: ``TestDDPCartPole.cpp:609-649``,
``TestFmpcOscillator.cpp:203-266``, tol 1e-6).  With autodiff the roles
flip: these helpers validate *user-supplied analytic* derivatives (and the
autodiff path itself) against central differences, and double as
fp32-vs-fp64 tolerance audits on the accelerator.
"""

from __future__ import annotations

import numpy as np


def _central_jac(f, z, eps):
    z = np.asarray(z, float)
    f0 = np.atleast_1d(np.asarray(f(z), float))
    J = np.zeros((f0.size, z.size))
    for j in range(z.size):
        d = np.zeros_like(z)
        d[j] = eps
        J[:, j] = (np.asarray(f(z + d), float) - np.asarray(f(z - d), float)) / (2 * eps)
    return J


def check_problem_derivatives(problem, t, x, u, eps=1e-6, tol=1e-5):
    """Cross-check a Problem's derivative functions vs central differences.
    Returns a dict of max abs errors; raises AssertionError above tol."""
    import jax.numpy as jnp

    x = np.asarray(x, float)
    u = np.asarray(u, float)
    errs = {}

    Fx, Fu = problem.linearize_dynamics(t, jnp.asarray(x), jnp.asarray(u))
    Fx_n = _central_jac(lambda z: problem.dynamics(t, jnp.asarray(z), jnp.asarray(u)), x, eps)
    Fu_n = _central_jac(lambda z: problem.dynamics(t, jnp.asarray(x), jnp.asarray(z)), u, eps)
    errs["Fx"] = float(np.abs(np.asarray(Fx) - Fx_n).max())
    errs["Fu"] = float(np.abs(np.asarray(Fu) - Fu_n).max())

    Lx, Lu, *_ = problem.quadraticize_running_cost(t, jnp.asarray(x), jnp.asarray(u))
    Lx_n = _central_jac(lambda z: [problem.running_cost(t, jnp.asarray(z), jnp.asarray(u))], x, eps)[0]
    Lu_n = _central_jac(lambda z: [problem.running_cost(t, jnp.asarray(x), jnp.asarray(z))], u, eps)[0]
    errs["Lx"] = float(np.abs(np.asarray(Lx) - Lx_n).max())
    errs["Lu"] = float(np.abs(np.asarray(Lu) - Lu_n).max())

    Vx, _ = problem.quadraticize_terminal_cost(t, jnp.asarray(x))
    Vx_n = _central_jac(lambda z: [problem.terminal_cost(t, jnp.asarray(z))], x, eps)[0]
    errs["Vx"] = float(np.abs(np.asarray(Vx) - Vx_n).max())

    if problem.ineq_const is not None:
        C, D = problem.linearize_ineq(t, jnp.asarray(x), jnp.asarray(u))
        C_n = _central_jac(lambda z: problem.ineq_const(t, jnp.asarray(z), jnp.asarray(u)), x, eps)
        D_n = _central_jac(lambda z: problem.ineq_const(t, jnp.asarray(x), jnp.asarray(z)), u, eps)
        errs["C"] = float(np.abs(np.asarray(C) - C_n).max())
        errs["D"] = float(np.abs(np.asarray(D) - D_n).max())

    bad = {k: v for k, v in errs.items() if v > tol}
    assert not bad, f"derivative check failed: {bad}"
    return errs
