"""The lane-kernel scaffolding (kernels/lane_kernel.py) and the ``auto``
rules that choose between the kernels and their XLA twins: block choice,
padding, backend gating, and the compile-cache location."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmpc_tpu.kernels import lane_kernel


@pytest.mark.parametrize("B", [1, 3, 8, 17, 32, 40, 256, 4096, 4097])
def test_block_config_invariants(B):
    """BLOCK is a power of two (Triton's block rule), holds one lane per
    thread of its warps, never exceeds a warp per program, and wastes
    less than half a block on padding for batches under a warp."""
    block, warps = lane_kernel.block_config(B)
    assert block & (block - 1) == 0 and 1 <= block <= 32
    assert warps >= 1 and block <= 32 * warps
    padded = -(-B // block) * block
    assert padded >= B and padded - B < block
    if B < 32:
        assert block < 2 * B


def _ddp_case(B, N=8):
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.kernels.ddp_backward import stack_derivs
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.solvers import ddp as D

    p = make_cartpole_problem(0.01)
    c = DDPConfig(horizon_steps=N, max_iter=10)
    rng = np.random.default_rng(5)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, N, 1)).astype(np.float32) * 0.2)
    xs, _ = D._rollout_stacked(p, c, 0.0, x0s, us)
    Ds, VxT, VxxT = jax.vmap(functools.partial(D._derivative_sweep, p, c),
                             in_axes=(None, 0, 0))(0.0, xs, us)
    S = stack_derivs(Ds.Fx, Ds.Fu, Ds.Lx, Ds.Lu, Ds.Lxx, Ds.Luu, Ds.Lxu)
    return (c, S, jnp.moveaxis(VxT, 0, -1), jnp.moveaxis(VxxT, 0, -1),
            jnp.full((B,), 1e-4, jnp.float32))


@pytest.mark.parametrize("B,block", [(40, None), (24, (16, 1))])
def test_kernel_pads_ragged_batch(monkeypatch, B, block):
    """B not a multiple of BLOCK: lanes are padded (edge values) and
    sliced off, and every real lane matches the stacked kernel."""
    from nmpc_tpu.kernels.ddp_backward import backward_stacked
    from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas

    monkeypatch.setattr(lane_kernel, "INTERPRET", True)
    if block is not None:
        monkeypatch.setattr(lane_kernel, "block_config", lambda _B: block)
    c, S, VxT, VxxT, lam = _ddp_case(B)
    o1 = backward_stacked(c, S, VxT, VxxT, lam)
    o2 = backward_pallas(c, S, VxT, VxxT, lam)
    for a, b in zip(o1, o2):
        assert a.shape == b.shape
    for a, b in zip(o1[:3], o2[:3]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=2e-5)
    assert bool(jnp.all(o1[3] == o2[3]))


def test_kernel_refuses_cpu_without_interpreter():
    from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas

    c, S, VxT, VxxT, lam = _ddp_case(32)
    with pytest.raises(lane_kernel.KernelUnavailableError):
        backward_pallas(c, S, VxT, VxxT, lam)


def _fake_backend(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_ddp_auto_backward_rule(monkeypatch, backend):
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.models.centroidal import make_centroidal_problem
    from nmpc_tpu.models.vertical import make_vertical_problem
    from nmpc_tpu.solvers.ddp import _resolve_backward_impl

    _fake_backend(monkeypatch, backend)
    kern = "remat" if backend == "gpu" else "stacked"
    c = DDPConfig()
    cart = make_cartpole_problem(0.01)
    f32, f64 = jnp.float32, jnp.float64
    assert _resolve_backward_impl(c, cart, f32, False, False) == kern
    # fp64 and full second-order DDP keep the XLA kernel everywhere
    assert _resolve_backward_impl(c, cart, f64, False, False) == "stacked"
    assert _resolve_backward_impl(c, cart, f32, False, True) == "stacked"
    # boxed: narrow inputs take the kernel, wide inputs the stacked BoxQP
    vert = make_vertical_problem(0.01)
    assert _resolve_backward_impl(c, vert, f32, True, False) == kern
    cent = make_centroidal_problem(0.03)
    assert _resolve_backward_impl(c, cent, f32, True, False) == "stacked"
    three = dataclasses.replace(vert, input_dim=3)
    assert _resolve_backward_impl(c, three, f32, True, False) == "stacked"
    boxed_cart = make_cartpole_problem(0.01, input_limits=(-15.0, 15.0))
    assert _resolve_backward_impl(c, boxed_cart, f32, True, False) == kern
    # fp64 derivative islands need the sweep: the sweep-fed kernel
    c64 = DDPConfig(deriv_dtype="float64")
    assert _resolve_backward_impl(c64, cart, f32, False, False) == (
        "pallas" if backend == "gpu" else "stacked")
    # an explicit choice is never overridden
    for impl in ("stacked", "pallas", "remat"):
        ci = dataclasses.replace(c, backward_impl=impl)
        assert _resolve_backward_impl(ci, cart, f32, False, False) == impl


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_ddp_auto_forward_rule(monkeypatch, backend):
    from nmpc_tpu.core.types import DDPConfig
    from nmpc_tpu.models.cartpole import make_cartpole_problem
    from nmpc_tpu.solvers.ddp import _resolve_forward_fused

    _fake_backend(monkeypatch, backend)
    p = make_cartpole_problem(0.01)
    f32, f64 = jnp.float32, jnp.float64
    auto = DDPConfig()
    assert _resolve_forward_fused(auto, p, f32, f32) == (backend == "gpu")
    # cost sums wider than the solve dtype break the kernel's contract
    assert not _resolve_forward_fused(auto, p, f32, f64)
    assert not _resolve_forward_fused(auto, p, f64, f64)
    scan = DDPConfig(forward_impl="scan")
    assert not _resolve_forward_fused(scan, p, f32, f32)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_fmpc_auto_rules(monkeypatch, backend):
    from nmpc_tpu.core.types import FmpcConfig
    from nmpc_tpu.solvers.fmpc import _resolve_impls

    _fake_backend(monkeypatch, backend)
    gpu = backend == "gpu"
    f32, f64 = jnp.float32, jnp.float64
    assert _resolve_impls(FmpcConfig(), f32, 4) == (
        "pallas" if gpu else "stacked", gpu)
    assert _resolve_impls(FmpcConfig(), f64, 4) == ("stacked", False)
    assert _resolve_impls(FmpcConfig(), f32, 0)[0] == "stacked"
    explicit = FmpcConfig(backward_impl="stacked", forward_impl="fused")
    assert _resolve_impls(explicit, f32, 4) == ("stacked", True)


def _explicit_ddp(field, value):
    from nmpc_tpu import DDPConfig, DDPSolver
    from nmpc_tpu.models.cartpole import make_cartpole_problem

    B, N = 32, 6
    c = dataclasses.replace(DDPConfig(horizon_steps=N, max_iter=2),
                            **{field: value})
    x0s = jnp.zeros((B, 4), jnp.float32)
    DDPSolver(make_cartpole_problem(0.01), c).solve_batch(
        jnp.float32(0.0), x0s, jnp.zeros((B, N, 1), jnp.float32))


def _explicit_fmpc(field, value):
    from nmpc_tpu.core.types import FmpcConfig, fmpc_variable_reset
    from nmpc_tpu.models.oscillator import make_oscillator_problem
    from nmpc_tpu.solvers.fmpc import FmpcSolver

    p = make_oscillator_problem(0.01)
    B, N = 32, 6
    var = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape),
        fmpc_variable_reset(N, 2, 1, 3, dtype=jnp.float32))
    c = dataclasses.replace(FmpcConfig(horizon_steps=N, max_iter=2),
                            **{field: value})
    FmpcSolver(p, c).solve_batch(jnp.float32(0.0),
                                 jnp.zeros((B, 2), jnp.float32), var,
                                 jnp.full((B,), 1e-4, jnp.float32))


@pytest.mark.parametrize("solve,field,value", [
    (_explicit_ddp, "backward_impl", "pallas"),
    (_explicit_ddp, "backward_impl", "remat"),
    (_explicit_ddp, "forward_impl", "fused"),
    (_explicit_fmpc, "backward_impl", "pallas"),
    (_explicit_fmpc, "forward_impl", "fused"),
])
def test_explicit_kernel_raises_on_cpu(solve, field, value):
    """An explicitly requested kernel on a backend that cannot compile it
    raises a clear error; it never falls back to the interpreter."""
    with pytest.raises(lane_kernel.KernelUnavailableError):
        solve(field, value)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from nmpc_tpu.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from nmpc_tpu.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".cache", "jax")
    assert ("jax_compilation_cache_dir", path) in calls


@pytest.mark.gpu
def test_compiled_kernels_match_xla_twins(gpu):
    """Each compiled kernel against its XLA twin at small widths (the
    full-width check is ``benchmarks/parity_gate.py``, run by
    ``chip_smoke.py``)."""
    from benchmarks import parity_gate as G
    from nmpc_tpu.models.cartpole import make_cartpole_fmpc_problem

    with jax.default_matmul_precision("highest"):
        checks = [G.check_ddp_backward(256, 20),
                  G.check_ddp_backward_boxed(128, 20),
                  G.check_ddp_backward_remat(False, 256, 20),
                  G.check_ddp_backward_remat(True, 128, 20),
                  G.check_ddp_forward(256, 20),
                  G.check_fmpc_backward(make_cartpole_fmpc_problem(0.01),
                                        256, 20),
                  G.check_fmpc_forward(256, 20)]
    assert all(c["pass"] for c in checks), checks


@pytest.mark.parametrize("boxed", [False, True])
def test_parity_gate_remat_check_interpreted(monkeypatch, boxed):
    """The gate's remat check, on the kernel in the Pallas interpreter at
    a tiny width, passes: it hands ``backward_remat`` the trajectory in the
    kernel's layout and compares it with the sweep-fed stacked backward."""
    from benchmarks import parity_gate as G

    monkeypatch.setattr(lane_kernel, "INTERPRET", True)
    with jax.default_matmul_precision("highest"):
        res = G.check_ddp_backward_remat(boxed, B=32, N=6)
    assert res["pass"], res
    assert res["ok_equal"] and res["max_err"] <= res["tol"]


def test_parity_gate_forward_check_interpreted(monkeypatch):
    """The gate's rollout check, interpreted at a tiny width, passes."""
    from benchmarks import parity_gate as G

    monkeypatch.setattr(lane_kernel, "INTERPRET", True)
    with jax.default_matmul_precision("highest"):
        res = G.check_ddp_forward(B=32, N=6)
    assert res["pass"] and res["max_err"] <= res["tol"], res


def test_roofline_peaks_known_and_unknown():
    """The roofline's peak table is keyed by device kind; an unknown
    device is an error, never a default."""
    from benchmarks.roofline import peaks

    h100 = peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["fp32_flops_per_s"] == 67e12
    with pytest.raises(KeyError):
        peaks("Some Other Accelerator")


def test_time_call_reports_median_and_quartiles():
    from benchmarks.timing import time_call

    f = jax.jit(lambda x: x * 2.0)
    t = time_call(f, jnp.ones((8,)), reps=5, warmup=1)
    assert t["n"] == 5
    assert 0 < t["q1"] <= t["median"] <= t["q3"]
    assert t["first"] > 0
