"""Lane-blocked batching helpers.

Arrays shaped ``[B, small]`` (vmap's natural layout) put the small dim on
the minor axis.  These helpers reshape a flat batch ``B = S * L`` into
trailing ``(S, L)`` axes and double-vmap user callables over them, so every
per-lane scalar in the traced computation becomes an ``[S, L]`` array with
the batch on the minor axes (a free reshape of the flat batch-minor
layout the kernels use).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lane_factors(n: int, lane: int = 128):
    """Split n = S * L with L the largest power-of-two <= lane dividing n."""
    L = lane
    while L > 1 and n % L != 0:
        L //= 2
    return n // L, L


def block_lanes(a, batch_axis, S, L):
    """Move ``batch_axis`` (size S*L) to trailing (S, L) axes."""
    a = jnp.moveaxis(a, batch_axis, -1)
    return a.reshape(a.shape[:-1] + (S, L))


def unblock_lanes(a, batch_axis):
    """Inverse of :func:`block_lanes`: trailing (S, L) -> batch at axis."""
    a = a.reshape(a.shape[:-2] + (-1,))
    return jnp.moveaxis(a, -1, batch_axis)


def vmap_lanes(f, n_array_args: int):
    """Double-vmap ``f(scalar_t, *arrays)`` over trailing (S, L) axes of the
    array args; scalars (first arg) broadcast."""
    in1 = (None,) + (-1,) * n_array_args
    g = jax.vmap(f, in_axes=in1, out_axes=-1)
    return jax.vmap(g, in_axes=in1, out_axes=-1)
