"""Evaluate small scalar jaxprs on lane-tile values.

The problem this solves: Pallas kernels that rematerialize per-stage
derivatives or roll out the dynamics need to run the problem's traced
callbacks (dynamics, cost gradients, jvp tangents) INSIDE the kernel on
lane-tile values.  Replaying those jaxprs under ``vmap`` keeps small
vectors as array dims whose layout the kernel compiler has to shuffle.

This module instead interprets the jaxpr directly in the hand-written
kernels' native data model: every jaxpr value of small shape
``(d0, ..., dk)`` becomes a flat row-major list of per-element values,
where each element is a lane tile (any shape; the kernels use 1-D
``(BLOCK,)`` tiles), a traced scalar, or a
**python literal**.  Consequences:

* transposes / reshapes / slices / concatenates are free list
  re-indexing — no data movement;
* reductions over small dims are Python sums of tiles — full-width
  elementwise adds;
* array constants (model weights) inline as python literals, so Pallas's
  no-captured-consts rule is satisfied with zero plumbing and the
  compiler constant-folds them;
* literal arithmetic folds at trace time (``0 * x -> 0``,
  ``1 * x -> x``, literal op literal -> literal evaluated at the jaxpr
  dtype), so evaluating a jvp jaxpr with a one-hot LITERAL seed
  sparsifies into exactly the analytic partial-derivative expressions —
  autogenerated analytic derivatives at tile level.

Unsupported primitives raise :class:`TileEvalError`; callers fall back
to the sweep-fed kernels (``backward_impl="pallas"``).

Folding caveat (documented contract): ``0 * x`` folds to ``0`` even when
``x`` could be non-finite.  Inside derivative tangents (the only place
literal zeros arise) operands are finite by construction; parity with
the XLA sweep is pinned by tests/test_tileval.py and the remat parity
tests.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class TileEvalError(NotImplementedError):
    """A jaxpr primitive/configuration this evaluator does not support."""


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


class TileVal:
    """A jaxpr value of small static shape, stored as a flat row-major
    list of per-element values (tile / traced scalar / python literal)."""

    __slots__ = ("shape", "dtype", "elems")

    def __init__(self, shape, dtype, elems):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = jnp.dtype(dtype)
        self.elems = list(elems)
        assert len(self.elems) == _prod(self.shape), (shape, len(elems))

    # ---- indexing helpers ------------------------------------------------

    def strides(self):
        st, acc = [], 1
        for s in reversed(self.shape):
            st.append(acc)
            acc *= s
        return tuple(reversed(st))

    def at(self, idx):
        st = self.strides()
        return self.elems[sum(i * s for i, s in zip(idx, st))]

    @staticmethod
    def from_array(a):
        """Concrete numpy/jax array -> literals (row-major)."""
        arr = np.asarray(a)
        return TileVal(arr.shape, arr.dtype,
                       [arr.reshape(-1)[i].item() for i in range(arr.size)])

    @staticmethod
    def from_tiles(tiles, shape, dtype):
        return TileVal(shape, dtype, list(tiles))


def _is_lit(v):
    return isinstance(v, (int, float, bool))


def _lit_cast(v, dtype):
    d = jnp.dtype(dtype)
    if d == jnp.bool_:
        return bool(v)
    if jnp.issubdtype(d, jnp.integer):
        return int(np.asarray(v).astype(d))
    return float(np.asarray(v, dtype=d))


def _np_unop(f32_fn):
    def run(v, dtype):
        return _lit_cast(f32_fn(np.asarray(v, dtype=dtype)), dtype)
    return run


# elementwise primitive tables -------------------------------------------
# each entry: (jnp op on tiles, literal evaluator(np values at dtype))

def _fold_mul(a, b):
    if _is_lit(a):
        if a == 0:
            return 0.0
        if a == 1:
            return b
    if _is_lit(b):
        if b == 0:
            return 0.0
        if b == 1:
            return a
    return None


def _fold_add(a, b):
    if _is_lit(a) and a == 0:
        return b
    if _is_lit(b) and b == 0:
        return a
    return None


def _fold_sub(a, b):
    if _is_lit(b) and b == 0:
        return a
    return None


_ELEMENTWISE2 = {
    "add": (jnp.add, lambda a, b: a + b, _fold_add),
    "add_any": (jnp.add, lambda a, b: a + b, _fold_add),
    "sub": (jnp.subtract, lambda a, b: a - b, _fold_sub),
    "mul": (jnp.multiply, lambda a, b: a * b, _fold_mul),
    "div": (jnp.divide, lambda a, b: a / b, None),
    "max": (jnp.maximum, np.maximum, None),
    "min": (jnp.minimum, np.minimum, None),
    "pow": (jnp.power, np.power, None),
    "atan2": (jnp.arctan2, np.arctan2, None),
    "rem": (jnp.remainder, np.remainder, None),
    "and": (jnp.logical_and, np.logical_and, None),
    "or": (jnp.logical_or, np.logical_or, None),
    "xor": (jnp.logical_xor, np.logical_xor, None),
    "lt": (lambda a, b: a < b, lambda a, b: a < b, None),
    "le": (lambda a, b: a <= b, lambda a, b: a <= b, None),
    "gt": (lambda a, b: a > b, lambda a, b: a > b, None),
    "ge": (lambda a, b: a >= b, lambda a, b: a >= b, None),
    "eq": (lambda a, b: a == b, lambda a, b: a == b, None),
    "ne": (lambda a, b: a != b, lambda a, b: a != b, None),
    "nextafter": (jnp.nextafter, np.nextafter, None),
}

_ELEMENTWISE1 = {
    "neg": (jnp.negative, lambda a: -a),
    "sin": (jnp.sin, np.sin),
    "cos": (jnp.cos, np.cos),
    "tan": (jnp.tan, np.tan),
    "asin": (jnp.arcsin, np.arcsin),
    "acos": (jnp.arccos, np.arccos),
    "atan": (jnp.arctan, np.arctan),
    "sinh": (jnp.sinh, np.sinh),
    "cosh": (jnp.cosh, np.cosh),
    "tanh": (jnp.tanh, np.tanh),
    "exp": (jnp.exp, np.exp),
    "log": (jnp.log, np.log),
    "log1p": (jnp.log1p, np.log1p),
    "expm1": (jnp.expm1, np.expm1),
    "sqrt": (jnp.sqrt, np.sqrt),
    "rsqrt": (jax.lax.rsqrt, lambda a: 1.0 / np.sqrt(a)),
    "abs": (jnp.abs, np.abs),
    "sign": (jnp.sign, np.sign),
    "floor": (jnp.floor, np.floor),
    "ceil": (jnp.ceil, np.ceil),
    "round": (jnp.round, np.round),
    "not": (jnp.logical_not, np.logical_not),
    "is_finite": (jnp.isfinite, np.isfinite),
    "logistic": (jax.nn.sigmoid, lambda a: 1.0 / (1.0 + np.exp(-a))),
    "stop_gradient": (lambda a: a, lambda a: a),
    "copy": (lambda a: a, lambda a: a),
}


def _broadcast_elem_idx(out_idx, in_shape, bcast_dims):
    """Map an output element index to the input element index for
    broadcast_in_dim."""
    idx = []
    for d, s in enumerate(in_shape):
        od = bcast_dims[d]
        idx.append(0 if s == 1 else out_idx[od])
    return tuple(idx)


def _iter_idx(shape):
    if not shape:
        yield ()
        return
    for flat in range(_prod(shape)):
        idx, rem = [], flat
        for s in shape:
            step = _prod(shape) // s if False else None  # unused
        # row-major decode
        acc = flat
        dims = []
        for s in reversed(shape):
            dims.append(acc % s)
            acc //= s
        yield tuple(reversed(dims))


class _Ctx:
    """Evaluation context: env (var -> TileVal) and a CSE memo shared by
    every evaluation in one kernel stage, so repeated primal
    sub-computations across per-column jvp evaluations unify at trace
    time (ids of tiles are stable python object ids)."""

    def __init__(self):
        self.memo = {}

    def key(self, prim_name, invals, params):
        ids = []
        for v in invals:
            ids.append(tuple(e if _is_lit(e) else id(e) for e in v.elems)
                       + (v.shape, str(v.dtype)))
        try:
            pk = tuple(sorted((k, str(p)) for k, p in params.items()))
        except Exception:  # pragma: no cover
            return None
        return (prim_name, tuple(ids), pk)


def eval_jaxpr_tiles(closed_jaxpr, args: Sequence[TileVal],
                     ctx: _Ctx | None = None) -> list:
    """Evaluate ``closed_jaxpr`` (consts inlined as literals) on TileVal
    args; returns a list of TileVal outputs."""
    if ctx is None:
        ctx = _Ctx()
    jaxpr = closed_jaxpr.jaxpr
    env: dict = {}

    def read(atom):
        if hasattr(atom, "val"):  # Literal
            return TileVal.from_array(atom.val)
        return env[atom]

    def write(var, val):
        env[var] = val

    for v, c in zip(jaxpr.constvars, closed_jaxpr.consts):
        write(v, TileVal.from_array(c))
    for v, a in zip(jaxpr.invars, args):
        write(v, a)

    for eqn in jaxpr.eqns:
        invals = [read(a) for a in eqn.invars]
        key = ctx.key(eqn.primitive.name, invals, eqn.params)
        if key is not None and key in ctx.memo:
            outs = ctx.memo[key]
        else:
            outs = _eval_eqn(eqn, invals, ctx)
            if key is not None:
                ctx.memo[key] = outs
        for v, o in zip(eqn.outvars, outs):
            write(v, o)

    return [read(v) for v in jaxpr.outvars]


def _binary(name, a: TileVal, b: TileVal, out_aval):
    opj, opl, fold = _ELEMENTWISE2[name]
    # jaxpr-level lax binaries are shape-equal (or scalar operands)
    shape = out_aval.shape
    dtype = out_aval.dtype

    def elem(i):
        ea = a.at(i) if a.shape == shape else a.elems[0]
        eb = b.at(i) if b.shape == shape else b.elems[0]
        if fold is not None:
            f = fold(ea, eb)
            if f is not None:
                return f if not _is_lit(f) else _lit_cast(f, dtype)
        if _is_lit(ea) and _is_lit(eb):
            return _lit_cast(opl(np.asarray(ea, a.dtype),
                                 np.asarray(eb, b.dtype)), dtype)
        ea = jnp.asarray(ea, a.dtype) if _is_lit(ea) else ea
        eb = jnp.asarray(eb, b.dtype) if _is_lit(eb) else eb
        return opj(ea, eb)

    return TileVal(shape, dtype, [elem(i) for i in _iter_idx(shape)])


def _eval_eqn(eqn, invals, ctx) -> list:
    prim = eqn.primitive.name
    params = eqn.params
    out_avals = [v.aval for v in eqn.outvars]

    if prim in _ELEMENTWISE2:
        return [_binary(prim, invals[0], invals[1], out_avals[0])]

    if prim in _ELEMENTWISE1:
        opj, opl = _ELEMENTWISE1[prim]
        a = invals[0]
        dtype = out_avals[0].dtype

        def elem(e):
            if _is_lit(e):
                return _lit_cast(opl(np.asarray(e, a.dtype)), dtype)
            return opj(e)

        return [TileVal(a.shape, dtype, [elem(e) for e in a.elems])]

    if prim == "integer_pow":
        y = params["y"]
        a = invals[0]
        dtype = out_avals[0].dtype

        def elem(e):
            if _is_lit(e):
                return _lit_cast(np.asarray(e, a.dtype) ** y, dtype)
            return jax.lax.integer_pow(e, y)

        return [TileVal(a.shape, dtype, [elem(e) for e in a.elems])]

    if prim == "convert_element_type":
        a = invals[0]
        dtype = out_avals[0].dtype

        def elem(e):
            if _is_lit(e):
                return _lit_cast(e, dtype)
            return e.astype(dtype) if hasattr(e, "astype") else jnp.asarray(
                e, dtype)

        return [TileVal(a.shape, dtype, [elem(e) for e in a.elems])]

    if prim == "select_n":
        which = invals[0]
        cases = invals[1:]
        shape, dtype = out_avals[0].shape, out_avals[0].dtype

        def elem(i):
            w = which.at(i) if which.shape == shape else which.elems[0]
            cs = [c.at(i) if c.shape == shape else c.elems[0] for c in cases]
            if _is_lit(w):
                return cs[int(bool(w))] if len(cs) == 2 else cs[int(w)]
            cs = [jnp.asarray(c, dtype) if _is_lit(c) else c for c in cs]
            if len(cs) == 2:
                return jnp.where(w, cs[1], cs[0])
            raise TileEvalError("select_n with >2 cases on traced pred")

        return [TileVal(shape, dtype, [elem(i) for i in _iter_idx(shape)])]

    if prim == "broadcast_in_dim":
        a = invals[0]
        shape = out_avals[0].shape
        bd = params["broadcast_dimensions"]
        elems = [a.at(_broadcast_elem_idx(i, a.shape, bd))
                 for i in _iter_idx(shape)]
        return [TileVal(shape, out_avals[0].dtype, elems)]

    if prim == "reshape":
        a = invals[0]
        return [TileVal(out_avals[0].shape, a.dtype, a.elems)]

    if prim == "squeeze":
        a = invals[0]
        return [TileVal(out_avals[0].shape, a.dtype, a.elems)]

    if prim == "expand_dims":
        a = invals[0]
        return [TileVal(out_avals[0].shape, a.dtype, a.elems)]

    if prim == "transpose":
        a = invals[0]
        perm = params["permutation"]
        shape = out_avals[0].shape
        # out[i0..ik] = in[i_{perm^-1}]: out dim k reads input dim perm[k]
        elems = []
        for i in _iter_idx(shape):
            in_idx = [0] * len(perm)
            for k, d in enumerate(perm):
                in_idx[d] = i[k]
            elems.append(a.at(tuple(in_idx)))
        return [TileVal(shape, a.dtype, elems)]

    if prim == "slice":
        a = invals[0]
        start = params["start_indices"]
        strides = params["strides"] or (1,) * len(start)
        shape = out_avals[0].shape
        elems = [a.at(tuple(s + i_ * st for s, i_, st in
                            zip(start, i, strides)))
                 for i in _iter_idx(shape)]
        return [TileVal(shape, a.dtype, elems)]

    if prim == "concatenate":
        dim = params["dimension"]
        shape = out_avals[0].shape
        elems = []
        for i in _iter_idx(shape):
            off = i[dim]
            for a in invals:
                if off < a.shape[dim]:
                    idx = list(i)
                    idx[dim] = off
                    elems.append(a.at(tuple(idx)))
                    break
                off -= a.shape[dim]
        return [TileVal(shape, out_avals[0].dtype, elems)]

    if prim in ("reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
                "reduce_and", "reduce_or"):
        a = invals[0]
        axes = params["axes"]
        shape = out_avals[0].shape
        dtype = out_avals[0].dtype
        red_shape = tuple(a.shape[d] for d in axes)
        kept = [d for d in range(len(a.shape)) if d not in axes]

        def combine(vals):
            if prim == "reduce_sum":
                op, lop = jnp.add, lambda x, y: x + y
            elif prim == "reduce_max":
                op, lop = jnp.maximum, max
            elif prim == "reduce_min":
                op, lop = jnp.minimum, min
            elif prim == "reduce_prod":
                op, lop = jnp.multiply, lambda x, y: x * y
            elif prim == "reduce_and":
                op, lop = jnp.logical_and, lambda x, y: x and y
            else:
                op, lop = jnp.logical_or, lambda x, y: x or y
            acc = vals[0]
            for v in vals[1:]:
                if _is_lit(acc) and _is_lit(v):
                    acc = lop(acc, v)
                elif prim == "reduce_sum" and _is_lit(v) and v == 0:
                    pass
                elif prim == "reduce_sum" and _is_lit(acc) and acc == 0:
                    acc = v
                else:
                    av = jnp.asarray(acc, dtype) if _is_lit(acc) else acc
                    bv = jnp.asarray(v, dtype) if _is_lit(v) else v
                    acc = op(av, bv)
            return _lit_cast(acc, dtype) if _is_lit(acc) else acc

        elems = []
        for i in _iter_idx(shape):
            vals = []
            for r in _iter_idx(red_shape):
                full = [0] * len(a.shape)
                for k, d in enumerate(kept):
                    full[d] = i[k]
                for k, d in enumerate(axes):
                    full[d] = r[k]
                vals.append(a.at(tuple(full)))
            elems.append(combine(vals))
        return [TileVal(shape, dtype, elems)]

    if prim == "dot_general":
        ((lc, rc), (lb, rb)) = params["dimension_numbers"]
        if lb or rb:
            raise TileEvalError("dot_general with batch dims")
        a, b = invals
        dtype = out_avals[0].dtype
        shape = out_avals[0].shape
        la_free = [d for d in range(len(a.shape)) if d not in lc]
        rb_free = [d for d in range(len(b.shape)) if d not in rc]
        red = tuple(a.shape[d] for d in lc)

        def elem(i):
            ia = i[:len(la_free)]
            ib = i[len(la_free):]
            terms = []
            for r in _iter_idx(red):
                ai = [0] * len(a.shape)
                bi = [0] * len(b.shape)
                for k, d in enumerate(la_free):
                    ai[d] = ia[k]
                for k, d in enumerate(lc):
                    ai[d] = r[k]
                for k, d in enumerate(rb_free):
                    bi[d] = ib[k]
                for k, d in enumerate(rc):
                    bi[d] = r[k]
                ea, eb = a.at(tuple(ai)), b.at(tuple(bi))
                f = _fold_mul(ea, eb)
                if f is not None:
                    terms.append(f)
                elif _is_lit(ea) and _is_lit(eb):
                    terms.append(float(np.asarray(ea, dtype)
                                       * np.asarray(eb, dtype)))
                else:
                    ea = jnp.asarray(ea, dtype) if _is_lit(ea) else ea
                    eb = jnp.asarray(eb, dtype) if _is_lit(eb) else eb
                    terms.append(ea * eb)
            acc = None
            for t_ in terms:
                if _is_lit(t_) and t_ == 0:
                    continue
                acc = t_ if acc is None else (
                    acc + t_ if not (_is_lit(acc) and _is_lit(t_))
                    else float(np.asarray(acc, dtype)
                               + np.asarray(t_, dtype)))
            if acc is None:
                acc = _lit_cast(0.0, dtype)
            return acc

        return [TileVal(shape, dtype, [elem(i) for i in _iter_idx(shape)])]

    if prim == "iota":
        dim = params["dimension"]
        shape = out_avals[0].shape
        dtype = out_avals[0].dtype
        elems = [_lit_cast(i[dim], dtype) for i in _iter_idx(shape)]
        return [TileVal(shape, dtype, elems)]

    if prim in ("jit", "pjit", "closed_call", "core_call", "remat_call",
                "checkpoint", "custom_jvp_call", "custom_vjp_call",
                "custom_jvp_call_jaxpr"):
        sub = params.get("jaxpr") or params.get("call_jaxpr")
        if sub is None:
            raise TileEvalError(f"call primitive without jaxpr: {prim}")
        if hasattr(sub, "jaxpr"):      # ClosedJaxpr
            return eval_jaxpr_tiles(sub, invals, ctx)
        closed = jax.extend.core.ClosedJaxpr(sub, []) if hasattr(
            jax.extend, "core") else None
        if closed is None:  # pragma: no cover
            raise TileEvalError(f"cannot wrap open jaxpr for {prim}")
        return eval_jaxpr_tiles(closed, invals, ctx)

    raise TileEvalError(f"unsupported primitive for tile evaluation: "
                        f"{prim}")


_CALL_PRIMS = ("jit", "pjit", "closed_call", "core_call", "remat_call",
               "checkpoint", "custom_jvp_call", "custom_vjp_call",
               "custom_jvp_call_jaxpr")
_STRUCTURAL_PRIMS = ("integer_pow", "convert_element_type", "select_n",
                     "broadcast_in_dim", "reshape", "squeeze",
                     "expand_dims", "transpose", "slice", "concatenate",
                     "reduce_sum", "reduce_max", "reduce_min",
                     "reduce_prod", "reduce_and", "reduce_or",
                     "dot_general", "iota")


def jaxpr_tile_supported(closed_jaxpr, max_elems: int = 256) -> bool:
    """Static check: can :func:`eval_jaxpr_tiles` evaluate this jaxpr,
    and do all intermediates stay small (each value expands to one
    kernel op per element)?  Used by the solver's ``auto`` rule to gate
    the remat kernel per problem."""
    def walk(jaxpr):
        for v in list(jaxpr.constvars) + list(jaxpr.invars):
            if _prod(v.aval.shape) > max_elems:
                return False
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            for v in eqn.outvars:
                if _prod(v.aval.shape) > max_elems:
                    return False
            if name in _CALL_PRIMS:
                sub = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
                if sub is None:
                    return False
                if not walk(sub.jaxpr if hasattr(sub, "jaxpr") else sub):
                    return False
            elif name == "dot_general":
                if any(eqn.params["dimension_numbers"][1]):
                    return False
            elif (name not in _ELEMENTWISE1
                    and name not in _ELEMENTWISE2
                    and name not in _STRUCTURAL_PRIMS):
                return False
        return True

    return walk(closed_jaxpr.jaxpr)
