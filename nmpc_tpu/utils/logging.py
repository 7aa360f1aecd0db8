"""print_level-gated solver logging.

The reference gates ``std::cout`` diagnostics on an integer ``print_level``
(0-3) in every component (``DDPSolver.h:62-63``, ``BoxQP.h:35-36``,
``FmpcSolver.h:60-61``; usage e.g. ``DDPSolver.hpp:106-109,198-207``).
The XLA-native equivalent: ``print_level`` is a *static* config field, so
logging below the threshold is pruned at trace time (zero cost at the
default level 0); enabled messages emit via ``jax.debug.print`` from inside
jitted loops, optionally guarded by a runtime predicate (events like
"lambda exceeded" fire only on the iteration where they happen, matching
the reference's conditional prints).
"""

from __future__ import annotations

import jax
from jax import lax


def log(print_level: int, threshold: int, fmt: str, **kwargs) -> None:
    """Unconditional (per trace point) message at ``threshold`` or above."""
    if print_level >= threshold:
        jax.debug.print(fmt, **kwargs)


def log_when(print_level: int, threshold: int, pred, fmt: str, **kwargs):
    """Message gated on a runtime predicate (event-style diagnostics)."""
    if print_level >= threshold:
        lax.cond(
            pred,
            lambda kw: jax.debug.print(fmt, **kw),
            lambda kw: None,
            kwargs,
        )
