"""Host-side computation-duration instrumentation.

The reference times every phase with ``std::chrono`` inside the solver
(``DDPSolver::ComputationDuration``, ``DDPSolver.h:219-247``;
``FmpcSolver.h:254-288``).  Under XLA the whole solve is one fused device
computation, so phase-level on-device timing is meaningless; instead:

* :class:`ComputationDuration` reproduces the reference's schema with the
  host-measurable fields (solve / setup / opt) filled by :class:`Stopwatch`,
* per-kernel timing comes from ``jax.profiler`` traces
  (:func:`profile_solve`), the XLA-native equivalent of the reference's
  hand-rolled phase timers.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class ComputationDuration:
    """Schema-compatible with ``DDPSolver::ComputationDuration``
    (``DDPSolver.h:219-247``); all in milliseconds."""

    solve: float = 0.0
    setup: float = 0.0
    opt: float = 0.0
    derivative: float = 0.0
    backward: float = 0.0
    forward: float = 0.0
    Q: float = 0.0
    reg: float = 0.0
    gain: float = 0.0


class Stopwatch:
    """Minimal phase timer: ``with sw.phase('solve'): ...``."""

    def __init__(self):
        self.durations_ms = {}

    def phase(self, name):
        return _Phase(self, name)

    def as_computation_duration(self) -> ComputationDuration:
        d = ComputationDuration()
        for k, v in self.durations_ms.items():
            if hasattr(d, k):
                setattr(d, k, v)
        return d


class _Phase:
    def __init__(self, sw, name):
        self.sw, self.name = sw, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = 1e3 * (time.perf_counter() - self.t0)
        self.sw.durations_ms[self.name] = (
            self.sw.durations_ms.get(self.name, 0.0) + dt)
        return False


def timed_solve(solver, *args, **kwargs):
    """Run ``solver.solve`` with host timing; returns (result, duration).

    ``duration.solve`` includes device execution (blocked on completion),
    like the reference's end-to-end ``solve`` timer."""
    import jax

    sw = Stopwatch()
    with sw.phase("solve"):
        res = solver.solve(*args, **kwargs)
        jax.block_until_ready(res)
    return res, sw.as_computation_duration()


def profile_solve(solver, *args, log_dir=None, **kwargs):
    """Capture a jax.profiler trace of one solve (kernel-level timing —
    the XLA-native replacement for the reference's phase timers) under
    ``log_dir`` (default ``<checkout>/.cache/profile``)."""
    import os

    import jax

    from nmpc_tpu.utils.cache import CHECKOUT

    if log_dir is None:
        log_dir = os.path.join(CHECKOUT, ".cache", "profile")

    with jax.profiler.trace(log_dir):
        res = solver.solve(*args, **kwargs)
        jax.block_until_ready(res)
    return res, log_dir
