"""Optimal-control problem abstraction.

The reference expresses problems as abstract classes with virtual methods for
dynamics/cost and *hand-written analytic derivatives*
(``nmpc_ddp/include/nmpc_ddp/DDPProblem.h:99-198``,
``nmpc_fmpc/include/nmpc_fmpc/FmpcProblem.h:94-107``).

Accelerator-native redesign: a problem is a frozen bundle of **pure jittable
callables**; derivatives default to autodiff (``jacfwd`` / ``hessian``), with
optional user-supplied analytic derivative callables covering the reference's
signature set.  Time-varying input / inequality dimensions
(``DDPProblem.h:74-85``, exercised by ``TestDDPVerticalMotion.cpp:58-75``)
become *static max-dim padding + boolean masks* since XLA requires static
shapes: a stage with ``k`` active inputs exposes ``input_mask(t)`` with ``k``
ones; the solvers zero the inactive columns and pin unit diagonals so that
the padded solve is exactly the reference's variable-dimension solve embedded
in the larger space.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Problem:
    """Discrete-time optimal control problem (DDP / FMPC solvers).

    Equivalent of ``DDPProblem<StateDim, InputDim>`` (``DDPProblem.h:15``) and
    its FMPC extension with inequality constraints ``g(x,u) <= 0``
    (``FmpcProblem.h:94-107``).

    Required callables (all pure, jittable, time in seconds):
      dynamics(t, x, u) -> x_next          (discrete state equation)
      running_cost(t, x, u) -> scalar
      terminal_cost(t, x) -> scalar
    Optional:
      ineq_const(t, x, u) -> g [ineq_dim]  (g <= 0 feasible)
      *_derivs               analytic derivatives; autodiff when None
      input_mask(t) -> bool[input_dim]     active-input mask (time-varying dims)
      ineq_mask(t) -> bool[ineq_dim]       active-inequality mask
      input_limits(t) -> (lower, upper)    box bounds for constrained DDP
    """

    dt: float
    state_dim: int
    input_dim: int
    dynamics: Callable
    running_cost: Callable
    terminal_cost: Callable
    ineq_dim: int = 0
    ineq_const: Optional[Callable] = None
    dynamics_derivs: Optional[Callable] = None       # (t,x,u)->(Fx,Fu)
    dynamics_second_derivs: Optional[Callable] = None  # (t,x,u)->(Fxx,Fuu,Fxu)
    running_cost_derivs: Optional[Callable] = None   # (t,x,u)->(Lx,Lu,Lxx,Luu,Lxu)
    terminal_cost_derivs: Optional[Callable] = None  # (t,x)->(Vx,Vxx)
    ineq_derivs: Optional[Callable] = None           # (t,x,u)->(C,D)
    input_mask: Optional[Callable] = None            # t->bool[input_dim]
    ineq_mask: Optional[Callable] = None             # t->bool[ineq_dim]
    input_limits: Optional[Callable] = None          # t->(lower,upper)

    # ---- derivative resolution (autodiff defaults) -------------------------

    def linearize_dynamics(self, t, x, u):
        """(Fx, Fu): first-order dynamics derivatives.

        Reference: ``DDPProblem::calcStateEqDeriv`` (``DDPProblem.h:123``).
        """
        if self.dynamics_derivs is not None:
            return self.dynamics_derivs(t, x, u)
        Fx = jax.jacfwd(self.dynamics, argnums=1)(t, x, u)
        Fu = jax.jacfwd(self.dynamics, argnums=2)(t, x, u)
        return Fx, Fu

    def second_order_dynamics(self, t, x, u):
        """(Fxx, Fuu, Fxu) rank-3 tensors [nx, ., .].

        The reference declares but does not implement these terms
        (``DDPSolver.hpp:391-414``); autodiff delivers them.
        """
        if self.dynamics_second_derivs is not None:
            return self.dynamics_second_derivs(t, x, u)
        Fxx = jax.jacfwd(jax.jacfwd(self.dynamics, argnums=1), argnums=1)(t, x, u)
        Fuu = jax.jacfwd(jax.jacfwd(self.dynamics, argnums=2), argnums=2)(t, x, u)
        Fxu = jax.jacfwd(jax.jacfwd(self.dynamics, argnums=1), argnums=2)(t, x, u)
        return Fxx, Fuu, Fxu

    def quadraticize_running_cost(self, t, x, u):
        """(Lx, Lu, Lxx, Luu, Lxu).

        Reference: ``DDPProblem::calcRunningCostDeriv`` (``DDPProblem.h:155-181``).
        """
        if self.running_cost_derivs is not None:
            return self.running_cost_derivs(t, x, u)
        Lx = jax.grad(self.running_cost, argnums=1)(t, x, u)
        Lu = jax.grad(self.running_cost, argnums=2)(t, x, u)
        Lxx = jax.hessian(self.running_cost, argnums=1)(t, x, u)
        Luu = jax.hessian(self.running_cost, argnums=2)(t, x, u)
        Lxu = jax.jacfwd(jax.grad(self.running_cost, argnums=1), argnums=2)(t, x, u)
        return Lx, Lu, Lxx, Luu, Lxu

    def quadraticize_terminal_cost(self, t, x):
        """(Vx, Vxx). Reference: ``calcTerminalCostDeriv`` (``DDPProblem.h:185-198``)."""
        if self.terminal_cost_derivs is not None:
            return self.terminal_cost_derivs(t, x)
        Vx = jax.grad(self.terminal_cost, argnums=1)(t, x)
        Vxx = jax.hessian(self.terminal_cost, argnums=1)(t, x)
        return Vx, Vxx

    def linearize_ineq(self, t, x, u):
        """(C, D): inequality-constraint Jacobians.

        Reference: ``FmpcProblem::calcIneqConstDeriv`` (``FmpcProblem.h:103``).
        """
        if self.ineq_derivs is not None:
            return self.ineq_derivs(t, x, u)
        C = jax.jacfwd(self.ineq_const, argnums=1)(t, x, u)
        D = jax.jacfwd(self.ineq_const, argnums=2)(t, x, u)
        return C, D

    # ---- mask helpers ------------------------------------------------------

    def input_mask_at(self, t):
        if self.input_mask is None:
            return jnp.ones((self.input_dim,), dtype=bool)
        return self.input_mask(t)

    def ineq_mask_at(self, t):
        if self.ineq_mask is None:
            return jnp.ones((self.ineq_dim,), dtype=bool)
        return self.ineq_mask(t)


@dataclasses.dataclass(frozen=True)
class ContinuousProblem:
    """Continuous-time OC problem via Pontryagin, for the C/GMRES solver.

    Equivalent of ``nmpc_cgmres::CgmresProblem``
    (``nmpc_cgmres/include/nmpc_cgmres/CgmresProblem.h:27-48``).  ``u`` may be
    augmented with dummy inputs and equality-constraint multipliers
    (``dim_uc = dim_u + dim_c``, ``CgmresProblem.h:57-60``).

    Required:
      state_eq(t, x, u) -> dx/dt
    Either supply analytic ``costate_eq`` / ``dphi_dx`` / ``dh_du`` (matching
    the reference's virtuals) or supply ``running_cost``/``terminal_cost``
    (+ optional ``eq_const`` with multiplier layout) and let autodiff derive
    them from the Hamiltonian H = L + lambda^T f (+ mu^T C) — an honest
    improvement over hand-derived costates.
    """

    dim_x: int
    dim_u: int
    dim_c: int
    state_eq: Callable                      # (t, x, u[:dim_u]) -> xdot
    costate_eq: Optional[Callable] = None   # (t, lmd, x, uc) -> dlmd/dt
    dphi_dx: Optional[Callable] = None      # (t, x) -> [dim_x]
    dh_du: Optional[Callable] = None        # (t, x, uc, lmd) -> [dim_uc]
    running_cost: Optional[Callable] = None  # (t, x, uc) -> scalar (may use dummies)
    terminal_cost: Optional[Callable] = None  # (t, x) -> scalar
    eq_const: Optional[Callable] = None     # (t, x, uc) -> [dim_c]  (== 0)
    x_initial: Optional[jnp.ndarray] = None
    u_initial: Optional[jnp.ndarray] = None

    @property
    def dim_uc(self) -> int:
        return self.dim_u + self.dim_c

    def hamiltonian(self, t, x, uc, lmd):
        """H = L(t,x,uc) + lambda . f(t,x,u) [+ mu . C(t,x,uc)].

        The multiplier block of ``uc`` enters through ``eq_const`` exactly as
        in the reference's dummy-input encoding
        (``tests/src/SemiactiveDamperProblem.h:86-103``).
        """
        u = uc[: self.dim_u]
        h = self.running_cost(t, x, uc) + lmd @ self.state_eq(t, x, u)
        if self.dim_c > 0 and self.eq_const is not None:
            mu = uc[self.dim_u:]
            h = h + mu @ self.eq_const(t, x, uc)
        return h

    def costate_eq_at(self, t, lmd, x, uc):
        """dlambda/dt = -dH/dx (``CgmresProblem.h:33``)."""
        if self.costate_eq is not None:
            return self.costate_eq(t, lmd, x, uc)
        return -jax.grad(self.hamiltonian, argnums=1)(t, x, uc, lmd)

    def dphi_dx_at(self, t, x):
        if self.dphi_dx is not None:
            return self.dphi_dx(t, x)
        return jax.grad(self.terminal_cost, argnums=1)(t, x)

    def dh_du_at(self, t, x, uc, lmd):
        """dH/du over the augmented input (``CgmresProblem.h:44``).

        Note: for the multiplier block this is the equality-constraint
        residual itself, which the Hamiltonian gradient reproduces.
        """
        if self.dh_du is not None:
            return self.dh_du(t, x, uc, lmd)
        return jax.grad(self.hamiltonian, argnums=2)(t, x, uc, lmd)
