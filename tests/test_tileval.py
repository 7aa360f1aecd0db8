"""Unit tests for kernels/tileval.py — the jaxpr-on-lane-tiles
interpreter behind the whole-iteration remat backward kernel.

Contract: for a supported jaxpr, evaluating on tile inputs must match
evaluating the original function pointwise per lane (tested against
vmap), with literal folding changing values only at fp-noise level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmpc_tpu.kernels.tileval import (TileVal, _Ctx, eval_jaxpr_tiles,
                                      jaxpr_tile_supported, TileEvalError)

BLOCK = 32     # the lane kernels' 1-D tile: one lane per thread


def _tiles(rng, n):
    return [jnp.asarray(rng.normal(size=(BLOCK,)).astype(np.float32))
            for _ in range(n)]


def _materialize(tv: TileVal):
    """TileVal -> dense [**shape, BLOCK] array (literals broadcast)."""
    elems = [jnp.broadcast_to(jnp.asarray(e, tv.dtype), (BLOCK,))
             for e in tv.elems]
    return jnp.stack(elems).reshape(tv.shape + (BLOCK,))


def _vmap_tile(f, n_arrays):
    """vmap ``f(scalar_t, *arrays)`` over the trailing tile axis."""
    return jax.vmap(f, in_axes=(None,) + (-1,) * n_arrays, out_axes=-1)


def _ref(f, *arrs):
    """Reference: vmap f over the trailing tile axis."""
    return _vmap_tile(f, len(arrs))(jnp.float32(0.7), *arrs)


def _check(f, shapes, seed=0, atol=1e-6):
    rng = np.random.default_rng(seed)
    tile_lists = [_tiles(rng, int(np.prod(s))) for s in shapes]
    avals = [jax.ShapeDtypeStruct((), jnp.float32)] + [
        jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    closed = jax.make_jaxpr(f)(*avals)
    assert jaxpr_tile_supported(closed), closed
    args = [TileVal((), jnp.float32, [jnp.float32(0.7)])] + [
        TileVal(s, jnp.float32, tl) for s, tl in zip(shapes, tile_lists)]
    out = eval_jaxpr_tiles(closed, args, _Ctx())
    ref = _ref(f, *[jnp.stack(tl).reshape(s + (BLOCK,))
                    for s, tl in zip(shapes, tile_lists)])
    ref = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(np.asarray(_materialize(o)),
                                   np.asarray(r), atol=atol)


def test_elementwise_and_reductions():
    def f(t, x, u):
        y = jnp.sin(x) * jnp.cos(t) + jnp.exp(-(x ** 2))
        return jnp.sum(y * u[0]), jnp.max(x)

    _check(f, [(4,), (2,)])


def test_matvec_and_weights():
    A = jnp.asarray(np.random.default_rng(1).normal(size=(3, 4))
                    .astype(np.float32))

    def f(t, x, u):
        return A @ x + t * jnp.concatenate([u, u, u])[:3]

    _check(f, [(4,), (1,)])


def test_transpose_slice_stack():
    def f(t, x, u):
        M = jnp.stack([x, 2.0 * x, x - 1.0])          # [3, 4]
        return M.T[1:3] @ jnp.ones((3,), x.dtype), M[2]

    _check(f, [(4,), (1,)])


def test_select_and_compare():
    def f(t, x, u):
        return jnp.where(x > 0, x, -2.0 * x) + jnp.where(t > 0, 1.0, 0.0)

    _check(f, [(4,), (1,)])


def test_jvp_onehot_seed_folds_to_analytic_columns():
    """Evaluating a dynamics-jvp jaxpr with one-hot LITERAL seeds must
    reproduce jacfwd columns, and constant entries must fold to python
    literals (the sparsification the remat kernel relies on)."""
    from nmpc_tpu.models.cartpole import make_cartpole_problem

    p = make_cartpole_problem(0.01)
    nx, nu = 4, 1

    def dyn_jvp(t, x, u, dx, du):
        _, tang = jax.jvp(lambda xx, uu: p.dynamics(t, xx, uu), (x, u),
                          (dx, du))
        return tang

    sd = jax.ShapeDtypeStruct
    closed = jax.make_jaxpr(dyn_jvp)(
        sd((), jnp.float32), sd((nx,), jnp.float32), sd((nu,), jnp.float32),
        sd((nx,), jnp.float32), sd((nu,), jnp.float32))
    assert jaxpr_tile_supported(closed)

    rng = np.random.default_rng(0)
    x_t, u_t = _tiles(rng, nx), _tiles(rng, nu)
    t_v = jnp.float32(0.3)
    f2 = _vmap_tile(lambda tt, xx, uu: p.linearize_dynamics(tt, xx, uu), 2)
    Fx, _ = f2(t_v, jnp.stack(x_t), jnp.stack(u_t))

    ctx = _Ctx()
    n_lit = 0
    for c in range(nx):
        args = [TileVal((), jnp.float32, [t_v]),
                TileVal((nx,), jnp.float32, x_t),
                TileVal((nu,), jnp.float32, u_t),
                TileVal((nx,), jnp.float32,
                        [1.0 if a == c else 0.0 for a in range(nx)]),
                TileVal((nu,), jnp.float32, [0.0])]
        col = eval_jaxpr_tiles(closed, args, ctx)[0]
        n_lit += sum(isinstance(e, (int, float)) for e in col.elems)
        np.testing.assert_allclose(
            np.asarray(_materialize(col)), np.asarray(Fx[:, c]), atol=2e-6)
    # the cart-pole Jacobian has constant rows (identity + dt structure);
    # folding must discover them
    assert n_lit >= nx


def test_unsupported_primitive_gated():
    def f(t, x, u):
        return x[jnp.int32(u[0] > 0)]      # dynamic gather

    sd = jax.ShapeDtypeStruct
    closed = jax.make_jaxpr(f)(
        sd((), jnp.float32), sd((4,), jnp.float32), sd((1,), jnp.float32))
    assert not jaxpr_tile_supported(closed)
    args = [TileVal((), jnp.float32, [jnp.float32(0.0)]),
            TileVal((4,), jnp.float32, _tiles(np.random.default_rng(0), 4)),
            TileVal((1,), jnp.float32, _tiles(np.random.default_rng(1), 1))]
    with pytest.raises(TileEvalError):
        eval_jaxpr_tiles(closed, args, _Ctx())


def test_big_const_gated():
    table = jnp.asarray(np.zeros((1000,), np.float32))

    def f(t, x, u):
        return jnp.sum(table) + x

    sd = jax.ShapeDtypeStruct
    closed = jax.make_jaxpr(f)(
        sd((), jnp.float32), sd((4,), jnp.float32), sd((1,), jnp.float32))
    assert not jaxpr_tile_supported(closed)
