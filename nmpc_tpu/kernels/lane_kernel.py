"""Shared scaffolding of the lane-serial Pallas kernels (Triton route).

Every hand-written kernel in this package runs a recursion that is serial
over the horizon and independent across batch lanes: the DDP and FMPC
Riccati backward passes, the FMPC forward delta recursion and the DDP
selected-alpha rollout.  They share one layout:

* operands are batch-minor, ``[..., B]``; the grid runs over blocks of
  ``BLOCK`` lanes, and a program's block spans every leading dimension
  (stage, row, column) and ``BLOCK`` lanes, so leading dimensions are
  indexed with scalars, never blocked (Triton wants power-of-two block
  dimensions, and N, nx and ng are not);
* a "tile" is a 1-D ``(BLOCK,)`` vector, one lane per thread; the
  per-stage algebra is unrolled small-matrix math on lists of tiles;
* the stage loop is an in-kernel ``lax.fori_loop`` whose carry stays in
  registers, and stage fields are loaded each step from refs left in
  device memory; Triton's ``num_stages`` pipelines those loads.

:func:`lane_call` is the one ``pallas_call`` site.  It pads B up to a
multiple of ``BLOCK`` (edge lanes, sliced off the outputs), names the
Triton route, and refuses to run anywhere but a GPU unless the interpreter
is switched on (:data:`INTERPRET`, set by the CPU tests).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Run lane kernels in the Pallas interpreter (CPU tests only).  Off by
# default: a kernel requested on a backend that cannot compile it raises.
INTERPRET = False

# Software-pipelining depth of the stage loop's loads (Triton's default).
_NUM_STAGES = 3


class KernelUnavailableError(RuntimeError):
    """A lane kernel was requested where it cannot be compiled."""


def on_gpu() -> bool:
    """True when the default backend compiles lane kernels.  The ``auto``
    rules select kernels only there (never the interpreter)."""
    return jax.default_backend() == "gpu"


def require_kernels(what: str) -> None:
    if not (INTERPRET or on_gpu()):
        raise KernelUnavailableError(
            f"{what} is a Pallas/Triton GPU kernel; the default backend is "
            f"{jax.default_backend()!r}.  Use the plain XLA path "
            f"('stacked' / 'scan', or 'auto') on this backend.")


def block_config(B: int) -> tuple[int, int]:
    """(BLOCK, num_warps) for a batch of B lanes: one lane per thread, one
    warp per program.

    Every lane runs the whole horizon serially, so the only parallelism is
    the lane count.  Measured on an H100 (DDP backward, N=100, two runs):
    at B=4096 BLOCK 8/16/32/64 all ran 0.44-0.50 ms, and at B=256
    0.33-0.46 ms, with run-to-run spread as large as the differences, so
    the full warp stays.  Batches under a warp take the smallest power of
    two that holds them.
    """
    block = 32
    while block > 1 and block // 2 >= B:
        block //= 2
    return block, 1


def lane_call(kernel, *, name: str, inputs, out_shapes):
    """Run ``kernel`` over lane blocks of batch-minor ``inputs``.

    Args:
      kernel: ``kernel(*in_refs, *out_refs)``; each ref's block is the
        array's leading dims plus ``BLOCK`` lanes.
      name: kernel name (shows in profiler traces).
      inputs: arrays ``[..., B]`` sharing the trailing batch axis.
      out_shapes: ``(leading_shape, dtype)`` per output; each output is
        ``leading_shape + (B,)``.
    Returns the outputs, ``[..., B]`` each.
    """
    require_kernels(name)
    B = inputs[0].shape[-1]
    BLOCK, num_warps = block_config(B)
    Bp = -(-B // BLOCK) * BLOCK
    if Bp != B:
        pad = lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Bp - B)],
                                mode="edge")
        inputs = [pad(a) for a in inputs]

    def spec(lead):
        nlead = len(lead)
        return pl.BlockSpec(tuple(lead) + (BLOCK,),
                            lambda g, nlead=nlead: (0,) * nlead + (g,))

    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct(tuple(s) + (Bp,), d)
                   for s, d in out_shapes],
        grid=(Bp // BLOCK,),
        in_specs=[spec(a.shape[:-1]) for a in inputs],
        out_specs=[spec(s) for s, _ in out_shapes],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=_NUM_STAGES),
        interpret=INTERPRET,
        name=name,
    )(*inputs)
    if Bp != B:
        outs = [o[..., :B] for o in outs]
    return outs
