"""nmpc_tpu — a batched nonlinear model predictive control framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of isri-aist/NMPC
(three solver families: DDP/iLQG, FMPC = DMS + primal-dual interior point +
Riccati, and C/GMRES continuation), redesigned accelerator-first: autodiff
derivatives, scan-based recursions, batched solves via vmap, multi-device
scaling via jax.sharding.
"""

from nmpc_tpu.core.problem import ContinuousProblem, Problem
from nmpc_tpu.core.types import (
    BoxQPConfig,
    BoxQPStatus,
    DDPConfig,
    DDPResult,
    DDPStatus,
    DDPTrace,
    FmpcConfig,
    FmpcResult,
    FmpcStatus,
    FmpcVariable,
    fmpc_variable_reset,
)
from nmpc_tpu.solvers.ddp import DDPSolver
from nmpc_tpu.solvers.boxqp import boxqp_solve
from nmpc_tpu.solvers.fmpc import FmpcSolver
from nmpc_tpu.solvers.cgmres import CgmresConfig, CgmresSolver, CgmresState
from nmpc_tpu.solvers.gmres import gmres, gmres_dense

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "ContinuousProblem",
    "DDPConfig",
    "DDPResult",
    "DDPStatus",
    "DDPTrace",
    "DDPSolver",
    "FmpcConfig",
    "FmpcResult",
    "FmpcStatus",
    "FmpcVariable",
    "fmpc_variable_reset",
    "FmpcSolver",
    "CgmresConfig",
    "CgmresSolver",
    "CgmresState",
    "gmres",
    "gmres_dense",
    "BoxQPConfig",
    "BoxQPStatus",
    "boxqp_solve",
]
