"""Centroidal motion problem (9 states, up to 16 friction-pyramid forces).

Same family as the reference's DDP centroidal example
(``nmpc_ddp/tests/src/TestDDPCentroidalMotion.cpp:24-204``): state
x = [CoM, linear momentum, angular momentum], inputs are force magnitudes
along friction-pyramid ridges at contact vertices; the contact stance (and
hence the input dimension: 16 in stance, 0 in flight) changes over time.

Static-shape encoding: inputs statically padded to 16 with an all-on/all-off mask;
stance geometry (vertices/ridges [16, 3]) is a jnp-valued function of time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp

from nmpc_tpu.core.problem import Problem

GRAVITY_VEC = (0.0, 0.0, 9.80665)
MASS = 100.0  # [kg] (TestDDPCentroidalMotion.cpp:203)
NUM_RIDGES = 16


@dataclasses.dataclass(frozen=True)
class CentroidalCostWeight:
    """(``TestDDPCentroidalMotion.cpp:40-50``)."""

    running_pos: float = 1.0
    running_momentum: float = 0.0
    running_angular: float = 1.0
    running_u: float = 1e-6
    terminal_pos: float = 1.0
    terminal_momentum: float = 0.0
    terminal_angular: float = 1.0


def rect_stance(center_x, center_y=0.0, half_x=0.1, half_y=0.1):
    """16-column stance from a rectangle's 4 vertices x 4 pyramid ridges
    (``makeStanceDataFromRect``, ``TestDDPCentroidalMotion.cpp:206-237``).
    Returns (vertices [16,3], ridges [16,3])."""
    vs = jnp.asarray([
        [-half_x, -half_y, 0.0],
        [-half_x, half_y, 0.0],
        [half_x, half_y, 0.0],
        [half_x, -half_y, 0.0],
    ]) + jnp.asarray([center_x, center_y, 0.0])
    angles = 2.0 * jnp.pi * jnp.arange(4) / 4.0
    ridges = jnp.stack([0.5 * jnp.cos(angles), 0.5 * jnp.sin(angles),
                        jnp.ones(4)], axis=-1)
    ridges = ridges / jnp.linalg.norm(ridges, axis=-1, keepdims=True)
    vertices = jnp.repeat(vs, 4, axis=0)          # [16, 3]
    ridges = jnp.tile(ridges, (4, 1))             # [16, 3]
    return vertices, ridges


def example_stance_func(epsilon_t: float = 1e-6):
    """Reference stance schedule (``TestDDPCentroidalMotion.cpp:246-267``):
    stance at x=0 until 1.4 s, flight 1.4-1.6 s, stance at x=0.5 after.
    Returns (vertices(t), ridges(t), mask(t))."""

    v0, r0 = rect_stance(0.0)
    v1, r1 = rect_stance(0.5)

    def vertices(t):
        t = jnp.asarray(t) + epsilon_t
        return jnp.where(t < 1.4, v0, v1)

    def ridges(t):
        t = jnp.asarray(t) + epsilon_t
        return jnp.where(t < 1.4, r0, r1)

    def mask(t):
        t = jnp.asarray(t) + epsilon_t
        in_flight = (t >= 1.4) & (t < 1.6)
        return jnp.broadcast_to(jnp.logical_not(in_flight), (NUM_RIDGES,))

    return vertices, ridges, mask


def example_ref_pos_func(epsilon_t: float = 1e-6):
    """(``TestDDPCentroidalMotion.cpp:268-279``)."""

    def f(t):
        t = t + epsilon_t
        x = jnp.where(t < 1.5, 0.0, 0.5)
        return jnp.stack([x, jnp.zeros(()), jnp.ones(())])

    return f


def make_centroidal_problem(
    dt: float,
    stance_funcs=None,
    ref_pos_func: Optional[Callable] = None,
    cost_weight: CentroidalCostWeight = CentroidalCostWeight(),
    force_limits: Optional[tuple] = None,
) -> Problem:
    """xdot = [p/m, R u - m g, sum_i u_i (v_i - c) x r_i]
    (``TestDDPCentroidalMotion.cpp:70-93``).

    ``force_limits=(lo, hi)`` adds box bounds on the per-ridge force
    coefficients for boxed-DDP solves (``with_input_constraint=True``) —
    the natural unilateral-contact bound ``0 <= u_i <= f_max`` on the
    friction-pyramid ridge weights.  This is the wide-input (nu=16)
    boxed shape class the backward-kernel ``auto`` rule routes to the
    stacked BoxQP (the fused kernel unrolls nu^3 work and does not
    compile in useful time at this width; see
    ``solvers/ddp.py::_resolve_backward_impl``), priced by
    ``benchmarks/bench_all.py::bench_boxed_ddp_centroidal``."""
    if stance_funcs is None:
        stance_funcs = example_stance_func()
    vertices_f, ridges_f, mask_f = stance_funcs
    if ref_pos_func is None:
        ref_pos_func = example_ref_pos_func()

    w = cost_weight
    wx = jnp.concatenate([
        jnp.full(3, w.running_pos), jnp.full(3, w.running_momentum),
        jnp.full(3, w.running_angular)])
    wtx = jnp.concatenate([
        jnp.full(3, w.terminal_pos), jnp.full(3, w.terminal_momentum),
        jnp.full(3, w.terminal_angular)])
    gvec = jnp.asarray(GRAVITY_VEC)

    def dynamics(t, x, u):
        m = mask_f(t).astype(x.dtype)
        um = u * m
        V = vertices_f(t).astype(x.dtype)   # [16,3]
        R = ridges_f(t).astype(x.dtype)     # [16,3]
        com = x[:3]
        lin = x[3:6]
        com_dot = lin / MASS
        lin_dot = R.T @ um - MASS * gvec.astype(x.dtype)
        ang_dot = jnp.sum(um[:, None] * jnp.cross(V - com[None, :], R), axis=0)
        return x + dt * jnp.concatenate([com_dot, lin_dot, ang_dot])

    def _diff(t, x):
        ref = ref_pos_func(t).astype(x.dtype)
        return jnp.concatenate([x[:3] - ref, x[3:]])

    def running_cost(t, x, u):
        d = _diff(t, x)
        return 0.5 * jnp.sum(wx.astype(x.dtype) * d**2) + 0.5 * w.running_u * jnp.sum(u**2)

    def terminal_cost(t, x):
        d = _diff(t, x)
        return 0.5 * jnp.sum(wtx.astype(x.dtype) * d**2)

    limits_fn = None
    if force_limits is not None:
        lo, hi = force_limits
        limits_fn = lambda t: (jnp.full((NUM_RIDGES,), lo),
                               jnp.full((NUM_RIDGES,), hi))

    return Problem(
        dt=dt,
        state_dim=9,
        input_dim=NUM_RIDGES,
        dynamics=dynamics,
        running_cost=running_cost,
        terminal_cost=terminal_cost,
        input_mask=mask_f,
        input_limits=limits_fn,
    )
