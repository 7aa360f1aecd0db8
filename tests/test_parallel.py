"""Multi-device sharding tests on the 8-way virtual CPU mesh (conftest)."""

import jax
import jax.numpy as jnp
import numpy as np

from nmpc_tpu import DDPConfig, DDPSolver
from nmpc_tpu.models.cartpole import make_cartpole_problem
from nmpc_tpu.parallel.mesh import (
    batch_sharding,
    convergence_stats,
    make_mesh,
    make_sharded_solve,
    shard_batch,
)


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("dp", "sp")


def test_sharded_solve_matches_local():
    problem = make_cartpole_problem(0.01)
    solver = DDPSolver(problem, DDPConfig(horizon_steps=30, max_iter=10))
    mesh = make_mesh()
    B = 16
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        np.stack([[0.0, np.pi, 0.0, 0.0]] * B) + 0.1 * rng.normal(size=(B, 4))
    )
    us0 = jnp.zeros((B, 30, 1))
    x0s_sh, us0_sh = shard_batch(mesh, (x0s, us0))
    sharded = make_sharded_solve(solver, mesh)
    res_sh = sharded(0.0, x0s_sh, us0_sh)
    res_local = solver.solve_batch(0.0, x0s, us0)
    np.testing.assert_allclose(
        np.asarray(res_sh.us), np.asarray(res_local.us), atol=1e-10
    )
    np.testing.assert_array_equal(
        np.asarray(res_sh.status), np.asarray(res_local.status)
    )
    # outputs actually sharded over dp
    assert res_sh.us.sharding.spec == batch_sharding(mesh).spec


def test_horizon_sharded_riccati_matches_sequential():
    """Distributed suffix-scan Riccati over the sp axis == sequential
    recursion, on a (dp=2, sp=4) mesh (horizon split over 4 devices)."""
    from nmpc_tpu.parallel.horizon import solve_lqr_horizon_sharded
    from nmpc_tpu.solvers.parallel_riccati import (
        LQRStage,
        solve_lqr_sequential,
    )

    rng = np.random.default_rng(7)
    N, nx, nu = 64, 4, 2
    A = jnp.asarray(rng.normal(size=(N, nx, nx)) * 0.3 + np.eye(nx)[None])
    B = jnp.asarray(rng.normal(size=(N, nx, nu)) * 0.3)
    c = jnp.asarray(rng.normal(size=(N, nx)) * 0.1)
    W = rng.normal(size=(N, nx, nx)) * 0.3
    Qxx = jnp.asarray(W @ W.transpose(0, 2, 1) + 0.5 * np.eye(nx)[None])
    Wu = rng.normal(size=(N, nu, nu)) * 0.3
    Quu = jnp.asarray(Wu @ Wu.transpose(0, 2, 1) + np.eye(nu)[None])
    Qux = jnp.asarray(rng.normal(size=(N, nu, nx)) * 0.2)
    q = jnp.asarray(rng.normal(size=(N, nx)) * 0.2)
    r = jnp.asarray(rng.normal(size=(N, nu)) * 0.2)
    stage = LQRStage(A, B, c, Qxx, Quu, Qux, q, r)
    Wt = rng.normal(size=(nx, nx))
    S_T = jnp.asarray(Wt @ Wt.T + np.eye(nx))
    v_T = jnp.asarray(rng.normal(size=nx))

    mesh = make_mesh(dp=2, sp=4)
    Ks_seq, ks_seq = solve_lqr_sequential(stage, S_T, v_T)
    Ks, ks, Ss = solve_lqr_horizon_sharded(stage, S_T, v_T, mesh=mesh)

    np.testing.assert_allclose(np.asarray(Ks), np.asarray(Ks_seq),
                               atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(ks), np.asarray(ks_seq),
                               atol=1e-8, rtol=1e-8)
    assert Ss.shape == (N, nx + 1, nx + 1)


def test_convergence_stats_psum():
    problem = make_cartpole_problem(0.01)
    solver = DDPSolver(problem, DDPConfig(horizon_steps=30, max_iter=10))
    mesh = make_mesh()
    B = 8
    x0s = jnp.asarray(np.stack([[0.0, np.pi, 0.0, 0.0]] * B))
    us0 = jnp.zeros((B, 30, 1))
    res = make_sharded_solve(solver, mesh)(0.0, *shard_batch(mesh, (x0s, us0)))
    stats = convergence_stats(mesh, res)
    assert float(stats["n"]) == B
    assert 0.0 <= float(stats["success_rate"]) <= 1.0


def test_initialize_multihost_launcher_paths():
    """Launcher coverage: run initialize_multihost in a clean subprocess —
    (a) the explicit single-process coordinator path actually initializes
    the JAX distributed runtime, (b) the no-coordinator call is a
    single-process no-op, (c) a repeated explicit call leaves the running
    runtime alone, (d) meshes and sharded computation work afterwards."""
    import os
    import subprocess
    import sys

    code = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from nmpc_tpu.parallel.mesh import initialize_multihost, make_mesh, shard_batch

# explicit single-process coordinator: the real jax.distributed path
initialize_multihost("localhost:12397", 1, 0)
assert jax.distributed.is_initialized()
assert jax.process_count() == 1, jax.process_count()

# no coordinator: a single-process run, nothing to initialize
initialize_multihost()

# second explicit call: already initialized -> left alone, still usable
initialize_multihost("localhost:12397", 1, 0)

mesh = make_mesh(dp=2, sp=2)
(xs,) = shard_batch(mesh, (jnp.arange(8.0).reshape(8, 1),))
assert float(jnp.sum(xs)) == 28.0
print("LAUNCHER-OK")
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.getcwd()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert "LAUNCHER-OK" in out.stdout, (out.stdout, out.stderr[-2000:])


def test_initialize_multihost_explicit_failure_raises():
    """An explicit coordinator that cannot be reached is an error, not a
    silent single-process fallback."""
    import os
    import subprocess
    import sys

    code = """
import jax
jax.config.update("jax_platforms", "cpu")
from nmpc_tpu.parallel.mesh import initialize_multihost
try:
    initialize_multihost("localhost:1", 2, 5)
except Exception as e:
    print("RAISED", type(e).__name__)
else:
    print("SWALLOWED")
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.getcwd()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert "RAISED" in out.stdout, (out.stdout, out.stderr[-2000:])
