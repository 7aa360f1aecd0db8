"""Device mesh construction and sharded batch solving.

The reference has **zero parallelism** — every solver is a single-threaded
loop (SURVEY.md §2.5; e.g. ``DDPSolver.hpp:367``).  Here a
``jax.sharding.Mesh`` spans the devices, the batch axis is sharded with
``shard_map``, and reductions are XLA collectives (NCCL on GPUs).  The
devices of one host are joined all to all, so the mesh shape follows the
algorithm alone.

Axes
----
``dp``  — data/scenario parallelism: batch of independent solves sharded
          across devices (the dominant axis for MPC workloads).
``sp``  — sequence/horizon axis for the parallel-in-time Riccati
          components (solvers/parallel_riccati.py); size 1 for stock solves.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Initialize the JAX distributed runtime so that ``jax.devices()``
    spans every process's devices.  Call once per process before building
    meshes, with an explicit ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id``; a failure to reach the
    coordinator raises.  Without a coordinator address this is a
    single-process run and nothing is initialized; an already-initialized
    runtime is left alone.
    """
    if coordinator_address is None or jax.distributed.is_initialized():
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    devices: Optional[Sequence] = None,
    dp: Optional[int] = None,
    sp: int = 1,
) -> Mesh:
    """Build a (dp, sp) mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"dp*sp={dp * sp} must equal device count {n}"
    dev_array = np.array(devices).reshape(dp, sp)
    return Mesh(dev_array, axis_names=("dp", "sp"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays whose leading axis is the solve batch."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Place a pytree of batch-leading arrays onto the mesh, sharded on dp."""
    sh = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def make_sharded_solve(solver, mesh: Mesh):
    """The solver's batched solve with the batch sharded over ``dp``.

    Lanes are independent, so each device runs ``raw_solve_batch`` on its
    shard under ``shard_map`` (the lane kernels are custom calls the SPMD
    partitioner cannot split).  Returns solve(t0, x0s [B,nx], us0s
    [B,N,nu]) with B divisible by dp; every result leaf is batch-leading
    and stays sharded.
    """
    from jax import shard_map

    return jax.jit(shard_map(
        solver.raw_solve_batch, mesh=mesh,
        in_specs=(P(), P("dp"), P("dp")), out_specs=P("dp"),
        check_vma=False))


def convergence_stats(mesh: Mesh, result):
    """Global success-rate / mean-iteration statistics with an explicit
    psum over the ``dp`` axis (shard_map) — the batched analog of the
    reference's per-solve status reporting."""
    import jax.numpy as jnp
    from jax import shard_map

    def local_stats(status, iters):
        n = jnp.asarray(status.shape[0], jnp.float32)
        succ = jnp.sum((status == 1).astype(jnp.float32))
        it_sum = jnp.sum(iters.astype(jnp.float32))
        stats = jnp.stack([n, succ, it_sum])
        return jax.lax.psum(stats, axis_name="dp")

    f = shard_map(
        local_stats,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=P(),
    )
    total, succ, it_sum = f(result.status, result.iters)
    return {
        "n": total,
        "success_rate": succ / total,
        "mean_iters": it_sum / total,
    }
