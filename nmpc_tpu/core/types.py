"""Core pytree / config types for the NMPC framework.

Design notes
------------
Configurations are **frozen Python dataclasses** (hashable, baked into jit
traces as static constants), mirroring the plain-struct ``Configuration``
objects of the reference (``nmpc_ddp/include/nmpc_ddp/DDPSolver.h:47-110``,
``nmpc_fmpc/include/nmpc_fmpc/FmpcSolver.h:58-89``).

Results and traces are **registered pytree dataclasses** of jnp arrays so
they flow through jit/vmap/pjit and are trivially checkpointable — the
equivalent of the reference's ``ControlData`` / ``TraceData`` structs
(``DDPSolver.h:113-216``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


class DDPStatus(enum.IntEnum):
    """Per-solve status (per-batch-lane under vmap).

    Mirrors the reference's tri-state return of ``DDPSolver::procOnce``
    (``DDPSolver.hpp:144``: 0 continue, 1 terminate, -1 failure) plus the
    max-iteration exit (``DDPSolver.hpp:116-123``: loop ends with retval 0
    and ``solve`` returns false).
    """

    RUNNING = 0
    SUCCEEDED = 1            # small gradient or small cost update
    MAX_ITER_REACHED = 2     # loop exhausted (reference: solve() -> false)
    FAIL_BACKWARD_LAMBDA = 3  # lambda > lambda_max in backward retry loop
    FAIL_FORWARD_LAMBDA = 4   # lambda > lambda_max after rejected forward


@dataclasses.dataclass(frozen=True)
class DDPConfig:
    """DDP solver configuration.

    Field-for-field equivalent of the reference ``DDPSolver::Configuration``
    (``nmpc_ddp/include/nmpc_ddp/DDPSolver.h:47-110``).  ``alpha_list`` is the
    reference's 11-point log-spaced backtracking schedule 10^0..10^-3
    (``DDPSolver.h:50-60``).  Batched redesign: all alphas are rolled out in
    parallel (extra vmap axis) and the first acceptable one is selected,
    which reproduces the reference's first-accepted-in-order semantics.
    """

    horizon_steps: int = 100
    max_iter: int = 500
    # 0 none, 1 failure warnings, 3 per-iteration diagnostics — the
    # reference's print_level gate (DDPSolver.h:62-63); static, so level 0
    # compiles to nothing (see utils/logging.py).
    print_level: int = 0
    use_state_eq_second_derivative: bool = False
    with_input_constraint: bool = False
    reg_type: int = 1              # 1: Quu + lambda I, 2: Vxx + lambda I
    initial_lambda: float = 1e-4
    initial_dlambda: float = 1.0
    lambda_factor: float = 1.6
    lambda_min: float = 1e-6
    lambda_max: float = 1e10
    k_rel_norm_thre: float = 1e-4
    lambda_thre: float = 1e-5
    alpha_list: tuple = tuple(10.0 ** e for e in
                              [0.0, -0.3, -0.6, -0.9, -1.2, -1.5, -1.8,
                               -2.1, -2.4, -2.7, -3.0])
    cost_update_ratio_thre: float = 0.0
    cost_update_thre: float = 1e-7
    # Backward-pass kernel for the batched (stacked) solve path:
    # "stacked" = batch-minor XLA kernel (kernels/ddp_backward.py);
    # "pallas"  = fused Pallas/Triton GPU kernel, one program per block of
    #             lanes with the value-function carry in registers
    #             (kernels/ddp_backward_pallas.py; fp32, first-order);
    # "remat"   = the fused kernel fed by the trajectory instead of the
    #             derivative sweep: stage derivatives are recomputed
    #             in-kernel from (x_i, u_i) (kernels/ddp_backward_remat.py;
    #             fp32, deriv_dtype "same", first-order, tile-interpretable
    #             problem callbacks);
    # "auto"    = "pallas" on a GPU when eligible, else "stacked".
    backward_impl: str = "auto"
    # Mixed precision: dtype for the dynamics/cost derivative sweeps
    # (incl. terminal expansion), with everything downstream (backward,
    # rollouts) staying at the solve dtype.  "same" follows the solve
    # dtype; "float64" gives fp64 derivative islands inside an fp32 solve —
    # the r2 floor audit showed the fp32 u-parity floor (~4e-4 on
    # cart-pole) is set by conditioning of the derivative/forward path, not
    # by backward accumulation, so this is the targeted lever for problems
    # needing certified ~1e-4 u-parity at less than full-fp64 cost.
    # Requires jax_enable_x64 when set to "float64".
    deriv_dtype: str = "same"
    # Forward line-search evaluation strategy for the batched solve path
    # (identical accept decisions in all modes — the reference's serial
    # first-accept loop, DDPSolver.hpp:242-265):
    # "auto"  = adaptive (default): per-iteration lax.cond between head
    #           and sweep driven by an accept-history hysteresis
    #           predictor (try head iff the last ``ls_auto_hysteresis``
    #           consecutive iterations had every running lane accept
    #           alpha[0]).
    # "head"  = materialize the alpha[0] rollout first and sweep the
    #           remaining alphas only (lax.cond) when some running lane
    #           rejects it — 1 scan when full steps accept, 3 when
    #           someone backtracks;
    # "sweep" = cost-only sweep of ALL alphas every iteration (always 2
    #           scans) — competitive only when lanes backtrack DEEP into
    #           the schedule nearly every iteration (bipedal N=300);
    # "serial" = the reference's serial early-exit loop batched as a
    #           while_loop over alphas (per-trip trajectory-buffer copies),
    #           kept for apples-to-apples comparison with the reference's
    #           cost model.
    ls_mode: str = "auto"
    # How the line-search rollouts themselves are evaluated (orthogonal to
    # ls_mode, which decides WHICH alphas get evaluated):
    # "auto"  = the fused Pallas/Triton selected-alpha rollout
    #           (kernels/ddp_forward_remat.py: dynamics/cost/terminal
    #           tile-interpreted in-kernel) on a GPU when the rollout
    #           callables are tile-supported and cost sums stay at the
    #           solve dtype; scan otherwise;
    # "fused" = force the kernel (raises where it cannot run);
    # "scan"  = always the lax.scan paths.
    forward_impl: str = "auto"
    # Consecutive all-lanes-accept-alpha[0] iterations required before the
    # "auto" predictor tries the head path again after a reject (1 = a
    # one-step predictor).
    ls_auto_hysteresis: int = 2
    # Max backward-pass lambda-retry attempts per iteration. The reference
    # retries unboundedly until lambda > lambda_max (DDPSolver.hpp:191-209);
    # from lambda_min to lambda_max with factor 1.6 that is at most
    # ~ log(1e16)/log(1.6) + margin ~= 80 retries, so 100 is semantically
    # unbounded while keeping a static bound for diagnostics.
    max_backward_retries: int = 100
    # BoxQP sub-solver settings (reference BoxQP.h:33-55)
    boxqp: "BoxQPConfig" = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.boxqp is None:
            object.__setattr__(self, "boxqp", BoxQPConfig())
        if self.backward_impl not in ("auto", "stacked", "pallas", "remat"):
            raise ValueError(
                f"DDPConfig.backward_impl must be one of 'auto', 'stacked', "
                f"'pallas', 'remat'; got {self.backward_impl!r}")
        if self.deriv_dtype not in ("same", "float32", "float64"):
            raise ValueError(
                f"DDPConfig.deriv_dtype must be one of 'same', 'float32', "
                f"'float64'; got {self.deriv_dtype!r}")
        if self.ls_mode not in ("auto", "serial", "head", "sweep"):
            raise ValueError(
                f"DDPConfig.ls_mode must be one of 'auto', 'serial', "
                f"'head', 'sweep'; got {self.ls_mode!r}")
        if self.forward_impl not in ("auto", "fused", "scan"):
            raise ValueError(
                f"DDPConfig.forward_impl must be one of 'auto', 'fused', "
                f"'scan'; got {self.forward_impl!r}")

    def for_fp32(self, cost_scale: float = 1e3) -> "DDPConfig":
        """fp32-calibrated termination thresholds (SURVEY §7 "fp precision").

        The reference's fp64 defaults (cost_update_thre=1e-7) sit below fp32
        resolution for costs of order ``cost_scale``; without recalibration
        the solver churns until lambda overflow instead of terminating.
        eps_f32 * cost_scale ~ 1e-4 is the smallest trustworthy cost update.
        """
        import dataclasses as _dc

        return _dc.replace(
            self,
            cost_update_thre=max(self.cost_update_thre, 6e-8 * cost_scale * 2),
            k_rel_norm_thre=max(self.k_rel_norm_thre, 1e-4),
        )


@dataclasses.dataclass(frozen=True)
class BoxQPConfig:
    """Projected-Newton BoxQP configuration.

    Equivalent of reference ``BoxQP::Configuration``
    (``nmpc_ddp/include/nmpc_ddp/BoxQP.h:33-55``) with the same defaults,
    including ``max_iter = 500``.  The masked while-loop exits as soon as
    every lane has converged, so the high cap costs nothing in the common
    case (MPC-size problems converge in a handful of iterations — pinned
    by ``tests/test_boxqp.py::test_boxqp_worst_case_iterations``) while
    matching the reference's behavior on adversarial active sets.
    """

    max_iter: int = 500
    grad_thre: float = 1e-8
    rel_improve_thre: float = 1e-8
    step_factor: float = 0.6
    min_step: float = 1e-22
    armijo_param: float = 0.1
    # static bound on Armijo backtracking: the reference loop runs until
    # step < min_step (BoxQP.h:298-309), i.e. 0.6^k < 1e-22 => k >= 100;
    # 104 covers it with margin (80 would reach only 1.8e-18, so the
    # exhaustion exit would be unreachable)
    max_ls_iter: int = 104
    # number of projected-Newton iterations unrolled (masked) before the
    # while_loop continuation — in BOTH the stacked batched kernel and the
    # fused Pallas kernel (both continue with a while loop to max_iter, so
    # this is a perf-only split, never a correctness cap): unrolled
    # iterations fuse with no per-trip dispatch overhead, the continuation
    # preserves exact reference semantics for the rare lanes needing more
    # (the vertical-motion config needs 1-3 trips)
    unroll_iter: int = 4
    # width of the PARALLEL Armijo head in the batched kernel: the first
    # ls_block candidates (steps 1, 0.6, ..., 0.6^(ls_block-1)) are
    # evaluated in one batched block; lanes that accept none (rare — every
    # realistic accept lands well above 0.6^8 ~ 0.017) continue in an
    # exact masked sequential tail.  Bounds the per-QP-iteration memory
    # traffic (evaluating all candidates streams [K,n,n,B] broadcasts per
    # iteration)
    ls_block: int = 9


class BoxQPStatus(enum.IntEnum):
    """Return codes, matching the reference table ``BoxQP.h:375-383``."""

    NOT_FINISHED = 0
    MAX_ITER = 1
    MAX_LS_ITER = 2
    NO_BOUNDS = 3
    SMALL_IMPROVEMENT = 4
    SMALL_GRADIENT = 5
    ALL_CLAMPED = 6
    HESSIAN_NOT_PD = -1
    POSITIVE_DIR_DERIV = -2


@pytree_dataclass
class DDPTrace:
    """Per-iteration optimization trace, fixed-size arrays [max_iter+1].

    Schema mirrors reference ``DDPSolver::TraceData`` (``DDPSolver.h:179-216``);
    row 0 is the initial-rollout row (``DDPSolver.hpp:97-104``). Durations are
    measured on the host (see utils/timing.py) since device code is traced.
    """

    iter: jnp.ndarray
    cost: jnp.ndarray
    lam: jnp.ndarray
    dlam: jnp.ndarray
    alpha: jnp.ndarray
    k_rel_norm: jnp.ndarray
    cost_update_actual: jnp.ndarray
    cost_update_expected: jnp.ndarray
    cost_update_ratio: jnp.ndarray


@pytree_dataclass
class DDPResult:
    """Result of one DDP solve (batched: every leaf gains a leading axis).

    ``xs``/``us``/``costs`` mirror ``DDPSolver::ControlData``
    (``DDPSolver.h:113-123``); ``ks``/``Ks`` are the feedforward/feedback
    gains (``DDPSolver.h:358-362``), exposed for inter-solve affine feedback
    like the reference FMPC cart-pole driver (``TestFmpcCartPole.cpp:351-356``).
    """

    status: jnp.ndarray        # int32, DDPStatus
    success: jnp.ndarray       # bool  (status == SUCCEEDED)
    iters: jnp.ndarray         # int32 number of iterations executed
    xs: jnp.ndarray            # [N+1, nx]
    us: jnp.ndarray            # [N, nu]
    costs: jnp.ndarray         # [N+1]
    ks: jnp.ndarray            # [N, nu]
    Ks: jnp.ndarray            # [N, nu, nx]
    lam: jnp.ndarray
    dlam: jnp.ndarray
    trace: DDPTrace


class FmpcStatus(enum.IntEnum):
    """FMPC result status, matching the reference enum values
    (``nmpc_fmpc/include/nmpc_fmpc/FmpcSolver.h:92-114``)."""

    UNINITIALIZED = 0
    SUCCEEDED = 1
    ERROR_IN_FORWARD = 2
    ERROR_IN_BACKWARD = 3
    ERROR_IN_UPDATE = 4
    MAX_ITERATION_REACHED = 5
    ITERATION_CONTINUED = 6


@dataclasses.dataclass(frozen=True)
class FmpcConfig:
    """FMPC solver configuration, field-for-field with the reference
    ``FmpcSolver::Configuration`` (``FmpcSolver.h:58-89``) plus static
    bounds for jit-compiled loops."""

    horizon_steps: int = 100
    max_iter: int = 10
    # reference print_level gate (FmpcSolver.h:60-61); static (see
    # utils/logging.py): 1 failure warnings, 3 per-iteration KKT trace.
    print_level: int = 0
    kkt_error_thre: float = 1e-4
    check_nan: bool = True
    init_complementary_variable: bool = False
    update_barrier_eps: bool = True
    break_if_llt_fails: bool = False
    enable_line_search: bool = False
    merit_const_scale_from_lagrange_multipliers: bool = False
    # static bound for the merit-function Armijo backtracking while-loop
    # (reference: alpha_s_min = 1e-10 with halving => <= ~35 steps,
    # FmpcSolver.hpp:759-792)
    max_line_search_iter: int = 40
    # condensed-Riccati kernel for the batched solve path:
    #   "stacked" — batch-minor XLA scan (solvers/fmpc.py::_backward_bm)
    #   "pallas"  — fused Pallas/Triton GPU kernel with the (s_vec, P)
    #               carry in registers (kernels/fmpc_backward_pallas.py;
    #               fp32, ng >= 1)
    #   "auto"    — pallas on a GPU when eligible, stacked otherwise
    backward_impl: str = "auto"
    # forward delta-recursion evaluation for the batched solve path
    # (orthogonal to backward_impl):
    #   "auto"  — fused Pallas/Triton kernel (kernels/fmpc_forward_pallas.py:
    #             per-stage A/B/x_bar/k/K loaded in-kernel, dx carry in
    #             registers) on a GPU for fp32 solves; scan otherwise
    #   "fused" — force the kernel (raises where it cannot run);
    #   "scan"  — always the lax.scan path
    forward_impl: str = "auto"

    def __post_init__(self):
        if self.backward_impl not in ("auto", "stacked", "pallas"):
            raise ValueError(
                f"FmpcConfig.backward_impl must be one of 'auto', 'stacked', "
                f"'pallas'; got {self.backward_impl!r}")
        if self.forward_impl not in ("auto", "fused", "scan"):
            raise ValueError(
                f"FmpcConfig.forward_impl must be one of 'auto', 'fused', "
                f"'scan'; got {self.forward_impl!r}")


@pytree_dataclass
class FmpcVariable:
    """Primal-dual iterate, the pytree equivalent of the reference
    ``FmpcSolver::Variable`` (``FmpcSolver.h:117-158``).  Being an explicit
    pytree it doubles as the warm-start / checkpoint state."""

    xs: jnp.ndarray       # [N+1, nx]
    us: jnp.ndarray       # [N, nu]
    lambdas: jnp.ndarray  # [N+1, nx]  equality (dynamics) multipliers
    ss: jnp.ndarray       # [N, ng]    slack variables (>= 0)
    nus: jnp.ndarray      # [N, ng]    inequality multipliers (>= 0)


def fmpc_variable_reset(N, nx, nu, ng, x=0.0, u=0.0, lam=0.0, s=1.0, nu_=1.0,
                        dtype=None):
    """Constant-filled iterate (``FmpcSolver::Variable::reset``,
    ``FmpcSolver.hpp:42-68``)."""
    dtype = dtype or default_float()
    return FmpcVariable(
        xs=jnp.full((N + 1, nx), x, dtype),
        us=jnp.full((N, nu), u, dtype),
        lambdas=jnp.full((N + 1, nx), lam, dtype),
        ss=jnp.full((N, ng), s, dtype),
        nus=jnp.full((N, ng), nu_, dtype),
    )


@pytree_dataclass
class FmpcTrace:
    """Per-iteration trace (``FmpcSolver::TraceData``, ``FmpcSolver.h:232-251``)."""

    iter: jnp.ndarray
    kkt_error: jnp.ndarray


@pytree_dataclass
class FmpcResult:
    status: jnp.ndarray        # int32 FmpcStatus
    iters: jnp.ndarray
    variable: FmpcVariable
    kkt_error: jnp.ndarray     # KKT error at termination check
    ks: jnp.ndarray            # [N, nu] feedforward gains from last backward
    Ks: jnp.ndarray            # [N, nu, nx] feedback gains (used for
    #                            inter-solve feedback, TestFmpcCartPole.cpp:351-356)
    barrier_eps: jnp.ndarray   # final barrier parameter (carry across solves)
    trace: FmpcTrace


def default_float() -> Any:
    """Framework-wide default floating dtype (f64 when x64 is enabled)."""
    return jnp.asarray(0.0).dtype
