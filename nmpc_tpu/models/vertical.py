"""Vertical-motion problem: time-varying input dimension + box limits.

Same family as the reference's DDP vertical-motion example
(``nmpc_ddp/tests/src/TestDDPVerticalMotion.cpp:31-234``): point mass moving
vertically under gravity, actuated by 0..2 contact forces depending on time
(contact switches), forces bounded to [0, 30] N.

The reference uses ``InputDim == Eigen::Dynamic`` with ``inputDim(t)``
returning 0/1/2 (``TestDDPVerticalMotion.cpp:58-75``).  Here the input is
statically padded to 2 with an active mask — the static-shape encoding of
time-varying dimensions (SURVEY.md §1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp

from nmpc_tpu.core.problem import Problem

GRAVITY = 9.80665
MASS = 1.0  # [kg] (TestDDPVerticalMotion.cpp:232)
MAX_CONTACTS = 2


@dataclasses.dataclass(frozen=True)
class VerticalCostWeight:
    """(``TestDDPVerticalMotion.cpp:34-46``)."""

    running_x: tuple = (1.0, 1e-3)
    running_u: float = 1e-4
    terminal_x: tuple = (1.0, 1e-3)


def num_contacts(t, epsilon_t: float = 1e-6):
    """Active contact count over time (``TestDDPVerticalMotion.cpp:58-75``):
    2 for 2<t<3, 0 for 4.5<t<5, else 1."""
    t = t + epsilon_t
    return jnp.where(
        (2.0 < t) & (t < 3.0), 2,
        jnp.where((4.5 < t) & (t < 5.0), 0, 1),
    )


def input_mask(t):
    n = num_contacts(t)
    return jnp.arange(MAX_CONTACTS) < n


def make_vertical_problem(
    dt: float,
    ref_pos_func: Optional[Callable] = None,
    cost_weight: VerticalCostWeight = VerticalCostWeight(),
    force_limits: tuple = (0.0, 30.0),
    with_limits: bool = True,
) -> Problem:
    """x = [pos_z, vel_z]; xdot = [vel, sum(u)/m - g]
    (``TestDDPVerticalMotion.cpp:77-85``)."""
    if ref_pos_func is None:
        # 1 m until t=8 s then 0 m (TestDDPVerticalMotion.cpp:246-258)
        ref_pos_func = lambda t: jnp.where(t + 1e-6 < 8.0, 1.0, 0.0)

    wrx = jnp.asarray(cost_weight.running_x)
    wtx = jnp.asarray(cost_weight.terminal_x)
    wu = cost_weight.running_u

    def dynamics(t, x, u):
        return x + dt * jnp.stack([x[1], jnp.sum(u) / MASS - GRAVITY])

    def running_cost(t, x, u):
        ref = jnp.stack([jnp.asarray(ref_pos_func(t), x.dtype), jnp.zeros((), x.dtype)])
        dx = x - ref
        # NOTE: inactive (masked) inputs are held at zero by the solver, so
        # the padded quadratic input term equals the variable-dim one.
        return 0.5 * jnp.sum(wrx.astype(x.dtype) * dx**2) + 0.5 * wu * jnp.sum(u**2)

    def terminal_cost(t, x):
        ref = jnp.stack([jnp.asarray(ref_pos_func(t), x.dtype), jnp.zeros((), x.dtype)])
        dx = x - ref
        return 0.5 * jnp.sum(wtx.astype(x.dtype) * dx**2)

    limits_fn = None
    if with_limits:
        lo, hi = force_limits
        limits_fn = lambda t: (
            jnp.full((MAX_CONTACTS,), lo),
            jnp.full((MAX_CONTACTS,), hi),
        )

    return Problem(
        dt=dt,
        state_dim=2,
        input_dim=MAX_CONTACTS,
        dynamics=dynamics,
        running_cost=running_cost,
        terminal_cost=terminal_cost,
        input_mask=input_mask,
        input_limits=limits_fn,
    )
