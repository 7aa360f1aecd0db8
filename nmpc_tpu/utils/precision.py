"""Full-precision fp32 matrix products for the solvers.

On a GPU an fp32 matrix product at JAX's default precision may run in
TF32, which keeps about three decimal digits.  The solvers' small dense
products (model Jacobians, single-instance Riccati and BoxQP algebra,
GMRES) feed convergence tests and parity contracts, so every solver entry
point traces under ``jax.default_matmul_precision("highest")``.
"""

from __future__ import annotations

import jax


def full_precision(fn):
    """Wrap ``fn`` so that it traces with fp32 matmuls at full precision."""

    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
