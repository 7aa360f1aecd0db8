"""C/GMRES real-time NMPC solver (Ohtsuka's continuation method), batched in XLA.

Algorithmic equivalent of the reference ``nmpc_cgmres::CgmresSolver``
(``nmpc_cgmres/src/CgmresSolver.cpp``; Ohtsuka, Automatica 2004):

  * setup: initial input from Newton iterations with GMRES on
    dH/du = 0 (``CgmresSolver.cpp:8-64``),
  * shrinking -> steady horizon T(t) = T_s (1 - e^{-alpha t})
    (``CgmresSolver.cpp:151``),
  * per control step: forward state rollout over the horizon, backward
    costate integration, dH/du per division (``CgmresSolver.cpp:146-183``),
  * continuation linear system b = ((1 - zeta*dlt) DhDu - DhDu(t+dlt))/dlt
    solved matrix-free by GMRES with finite-difference directional products
    (``CgmresSolver.cpp:111-143, 186-202``), warm-started from the previous
    step's solution,
  * integration of u̇ into the input trajectory (``CgmresSolver.cpp:137-140``).

Accelerator-first: the whole control step (2 + k_max GMRES iterations, each a full
horizon sweep) fuses into ONE jitted XLA computation; horizon sweeps are
``lax.scan``; the closed-loop simulation is available as a host loop
(:meth:`run`) or a fully-on-device ``lax.scan`` (:meth:`simulate`) for
batched/benchmark use.  Optionally the finite-difference directional
products can use exact JVPs (``use_jvp=True``) — an honest improvement the
continuation math allows (the reference is FD-only).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from nmpc_tpu.core.integrators import INTEGRATORS
from nmpc_tpu.core.problem import ContinuousProblem
from nmpc_tpu.solvers.gmres import gmres
from nmpc_tpu.utils.precision import full_precision


@dataclasses.dataclass(frozen=True)
class CgmresConfig:
    """Parameters of the C/GMRES method, defaults matching the reference
    (``nmpc_cgmres/include/nmpc_cgmres/CgmresSolver.h:66-79``)."""

    sim_duration: float = 10.0
    steady_horizon_duration: float = 1.0
    horizon_divide_num: int = 25
    horizon_increase_ratio: float = 0.5
    dt: float = 0.001
    eq_zeta: float = 1000.0
    k_max: int = 5
    finite_diff_delta: float = 0.002
    ode_solver: str = "euler"        # horizon integration (reference: Euler)
    sim_ode_solver: str = "rk4"      # plant simulation (tests use RK4)
    use_jvp: bool = False            # exact JVPs instead of finite differences
    setup_newton_iters: int = 100    # CgmresSolver.cpp:31
    setup_tol: float = 1e-6
    # host-loop diagnostics gate (the reference streams progress to stdout
    # and /tmp dumps from run(), CgmresSolver.cpp:66-103)
    print_level: int = 0
    # every dump_step-th control step is written by run(dump_prefix=...)
    dump_step: int = 1


class CgmresState(NamedTuple):
    """Carry across control steps (the reference's mutable members)."""

    u_list: jnp.ndarray       # [N, dim_uc] input trajectory over horizon
    delta_u_vec: jnp.ndarray  # [N * dim_uc] GMRES warm start
    u: jnp.ndarray            # [dim_uc] current input
    err: jnp.ndarray          # ||dH/du|| optimality error


class CgmresSolver:
    def __init__(self, problem: ContinuousProblem,
                 config: CgmresConfig = CgmresConfig()):
        self.problem = problem
        self.config = config
        bind = lambda f: full_precision(functools.partial(f, problem, config))
        self._setup = jax.jit(bind(_setup))
        self._step = jax.jit(bind(_control_step))
        self._sim = jax.jit(bind(_simulate),
                            static_argnames=("n_steps",))
        # batched controllers: the lane-blocked batch-minor fleet kernel
        # (gmres_bm + batch-minor sweeps); vmap-of-single retained for
        # comparison/testing as _step_batch_vmap
        self._step_batch = jax.jit(
            bind(_control_step_bm))
        self._step_batch_vmap = jax.jit(jax.vmap(
            bind(_control_step),
            in_axes=(None, 0, 0, 0)))
        # batched closed loop rides the lane-blocked kernel end-to-end
        # (boundary transposes once, outside the scan); the vmap-of-single
        # variant is retained for parity testing as _sim_batch_vmap
        self._sim_batch = jax.jit(
            bind(_simulate_bm),
            static_argnames=("n_steps",))

        def _sim_batch_vmap(t0, x0s, states, n_steps):
            return jax.vmap(
                lambda x0, st: _simulate(problem, config, t0, x0, st,
                                         n_steps=n_steps))(x0s, states)

        self._sim_batch_vmap = jax.jit(full_precision(_sim_batch_vmap),
                                       static_argnames=("n_steps",))

    def setup(self, t0=0.0, x0=None, u0=None) -> CgmresState:
        """Initial input via Newton+GMRES on dH/du = 0
        (``CgmresSolver::setup``, ``CgmresSolver.cpp:8-64``)."""
        x0 = self.problem.x_initial if x0 is None else x0
        u0 = self.problem.u_initial if u0 is None else u0
        return self._setup(jnp.asarray(t0, jnp.asarray(x0).dtype),
                           jnp.asarray(x0), jnp.asarray(u0))

    def control_step(self, t, x, next_x, state: CgmresState) -> CgmresState:
        """One ``calcControlInput`` (``CgmresSolver.cpp:111-143``)."""
        return self._step(t, x, next_x, state)

    def control_step_batch(self, t, xs, next_xs, states) -> CgmresState:
        """Batched continuation updates for many controllers at once
        (state leaves and x arrays carry a leading batch axis)."""
        return self._step_batch(t, xs, next_xs, states)

    def simulate_batch(self, t0, x0s, states, n_steps: int):
        """Batched on-device closed-loop simulations."""
        return self._sim_batch(jnp.asarray(t0, x0s.dtype), x0s, states,
                               n_steps=n_steps)

    def simulate(self, t0=0.0, x0=None, n_steps: Optional[int] = None):
        """Fully-on-device closed-loop simulation (``CgmresSolver::run``,
        ``CgmresSolver.cpp:66-109``). Returns (ts, xs, us, errs)."""
        x0 = self.problem.x_initial if x0 is None else x0
        if n_steps is None:
            n_steps = int(round(self.config.sim_duration / self.config.dt)) + 1
        state = self.setup(t0, x0)
        return self._sim(jnp.asarray(t0, jnp.asarray(x0).dtype),
                         jnp.asarray(x0), state, n_steps=n_steps)

    def run(self, t0=0.0, x0=None, callback=None, dump_prefix=None):
        """Host-loop variant of :meth:`simulate` with per-step callback.

        ``dump_prefix`` (e.g. ``"/tmp/cgmres"``) streams
        ``{prefix}_{x,u,err,param}.dat`` in the reference's format
        (``CgmresSolver::run``, ``CgmresSolver.cpp:68-103``).
        """
        import numpy as np

        cfg = self.config
        x0 = self.problem.x_initial if x0 is None else x0
        x = jnp.asarray(x0)
        state = self.setup(t0, x)
        sim_f = INTEGRATORS[cfg.sim_ode_solver]
        f = lambda t, x, u: self.problem.state_eq(t, x, u[: self.problem.dim_u])
        ts, xs, us, errs = [], [], [], []
        t = t0
        n = int(round(cfg.sim_duration / cfg.dt)) + 1
        for i in range(n):
            next_x = sim_f(f, t, x, state.u, cfg.dt)
            state = self.control_step(t, x, next_x, state)
            ts.append(t)
            xs.append(np.asarray(x))
            us.append(np.asarray(state.u))
            errs.append(float(state.err))
            if cfg.print_level >= 3 and i % max(cfg.dump_step, 1) == 0:
                print(f"[CGMRES] t {t:.4f}: err {float(state.err):.6e}")
            if callback is not None:
                callback(t, x, state)
            x = next_x
            t += cfg.dt
        out = (np.asarray(ts), np.stack(xs), np.stack(us), np.asarray(errs))
        if dump_prefix is not None:
            from nmpc_tpu.utils.trace import dump_cgmres_data

            dump_cgmres_data(*out, prefix=dump_prefix,
                             dump_step=cfg.dump_step,
                             log_dt=cfg.dt * cfg.dump_step)
        return out


# --------------------------------------------------------------------------


def _calc_dhdu_list(problem: ContinuousProblem, config: CgmresConfig,
                    t, x, u_list):
    """Horizon sweep: forward states, backward costates, dH/du per division
    (``CgmresSolver::calcDhDuList``, ``CgmresSolver.cpp:146-183``)."""
    N = config.horizon_divide_num
    dtype = x.dtype
    ode = INTEGRATORS[config.ode_solver]
    f = lambda tau, xx, uc: problem.state_eq(tau, xx, uc[: problem.dim_u])

    T = config.steady_horizon_duration * (
        1.0 - jnp.exp(-config.horizon_increase_ratio * t))
    h = T / N

    taus = t + h * jnp.arange(N, dtype=dtype)

    def fwd(xx, tu):
        tau, u = tu
        xn = ode(f, tau, xx, u, h)
        return xn, xn

    xN, xs_tail = lax.scan(fwd, x, (taus, u_list))
    xs = jnp.concatenate([x[None], xs_tail], axis=0)  # [N+1, dim_x]

    lmd_N = problem.dphi_dx_at(t + T, xs[N])

    # backward costate integration at time tau_{i+1}, step -h, with (x_i, u_i)
    # (CgmresSolver.cpp:171-179)
    costate = lambda tau, lmd, xu: problem.costate_eq_at(
        tau, lmd, xu[: problem.dim_x], xu[problem.dim_x:])

    def bwd(lmd_next, inp):
        tau_next, xx, u = inp
        xu = jnp.concatenate([xx, u])
        lmd = ode(costate, tau_next, lmd_next, xu, -h)
        return lmd, lmd_next  # emit lambda_{i+1} for the DhDu eval

    taus_next = t + h * (1.0 + jnp.arange(N, dtype=dtype))
    _, lmd_next_list = lax.scan(bwd, lmd_N, (taus_next, xs[:-1], u_list),
                                reverse=True)

    # DhDu_i at (tau_i, x_i, u_i, lambda_{i+1}) (CgmresSolver.cpp:182)
    dhdu = jax.vmap(problem.dh_du_at)(taus, xs[:-1], u_list, lmd_next_list)
    return dhdu  # [N, dim_uc]


def _control_step(problem: ContinuousProblem, config: CgmresConfig,
                  t, x, next_x, state: CgmresState) -> CgmresState:
    """One continuation update (``CgmresSolver::calcControlInput``,
    ``CgmresSolver.cpp:111-143``)."""
    N = config.horizon_divide_num
    dlt = config.finite_diff_delta
    dt = config.dt
    u_list = state.u_list

    dhdu = _calc_dhdu_list(problem, config, t, x, u_list)

    t_wd = t + dlt
    x_wd = (1.0 - dlt / dt) * x + (dlt / dt) * next_x
    dhdu_wd = _calc_dhdu_list(problem, config, t_wd, x_wd, u_list)

    b = ((1.0 - config.eq_zeta * dlt) * dhdu.ravel() - dhdu_wd.ravel()) / dlt

    if config.use_jvp:
        # exact directional derivative of u_list -> DhDu_list at (t_wd, x_wd)
        def F(ul):
            return _calc_dhdu_list(problem, config, t_wd, x_wd, ul).ravel()

        def Amul(v):
            return jax.jvp(F, (u_list,), (v.reshape(N, -1),))[1]
    else:
        def Amul(v):
            ul = u_list + dlt * v.reshape(N, -1)
            dh = _calc_dhdu_list(problem, config, t_wd, x_wd, ul)
            return (dh.ravel() - dhdu_wd.ravel()) / dlt

    sol = gmres(Amul, b, state.delta_u_vec, k_max=config.k_max, eps=1e-10)

    u_list_new = u_list + dt * sol.x.reshape(N, -1)
    return CgmresState(
        u_list=u_list_new,
        delta_u_vec=sol.x,
        u=u_list_new[0],
        err=jnp.linalg.norm(dhdu),
    )


def _setup(problem: ContinuousProblem, config: CgmresConfig, t0, x0, u0
           ) -> CgmresState:
    """Initial input via Newton + GMRES (``CgmresSolver::setup``,
    ``CgmresSolver.cpp:8-64``)."""
    N = config.horizon_divide_num
    dlt = config.finite_diff_delta
    dtype = x0.dtype

    lmd0 = problem.dphi_dx_at(t0, x0)

    def newton_cond(carry):
        u, it, err = carry
        return (err > config.setup_tol) & (it < config.setup_newton_iters)

    def newton_body(carry):
        u, it, _ = carry
        dhdu = problem.dh_du_at(t0, x0, u, lmd0)

        def Amul(v):
            d = problem.dh_du_at(t0, x0, u + dlt * v, lmd0)
            return (d - dhdu) / dlt

        sol = gmres(Amul, -dhdu, jnp.zeros_like(u), k_max=problem.dim_uc,
                    eps=1e-10)
        u_new = u + sol.x
        err_new = jnp.linalg.norm(problem.dh_du_at(t0, x0, u_new, lmd0))
        return (u_new, it + 1, err_new)

    err0 = jnp.linalg.norm(problem.dh_du_at(t0, x0, u0, lmd0))
    u, _, err = lax.while_loop(newton_cond, newton_body,
                               (jnp.asarray(u0, dtype), jnp.int32(0), err0))

    u_list = jnp.tile(u[None], (N, 1))
    return CgmresState(
        u_list=u_list,
        delta_u_vec=jnp.zeros((N * problem.dim_uc,), dtype),
        u=u,
        err=err,
    )


# --------------------------------------------------------------------------
# lane-blocked (batch-minor) fleet path: the GMRES recurrences and horizon
# sweeps carry the controller batch on the TRAILING axis so every per-lane
# scalar (Givens coefficients, MGS dot products, residuals) is a full-lane
# [B] vector instead of a vmap-scalar — the same layout treatment that won
# for the DDP/FMPC Riccati kernels (kernels/ddp_backward.py).
# --------------------------------------------------------------------------


def gmres_bm(Amul, b, x0, k_max: int, eps: float = 1e-10):
    """Batch-minor GMRES: ``b``/``x0`` are [n, B]; ``Amul`` maps [n, B] ->
    [n, B] (all lanes at once).  Per-lane convergence masking reproduces
    ``gmres``-under-vmap semantics (Givens mode, reorth on): each lane
    freezes its own Arnoldi state once converged and the back-substitution
    truncates at that lane's OWN freeze iteration ``k_lane`` — a lane that
    converges at k=1 in a batch whose slowest lane runs to k_max leaves
    zero Hessenberg diagonals beyond its freeze point, and dividing by them
    (the r2 bug) produced NaN for exactly the early-converging lanes a real
    fleet has (controllers near steady state).
    Returns (x [n, B], iters per lane [B], rho [B])."""
    n, B = b.shape
    dtype = b.dtype
    k_max = min(k_max, n)

    r = b - Amul(x0)
    rho0 = jnp.linalg.norm(r, axis=0)                    # [B]
    b_norm = jnp.linalg.norm(b, axis=0)

    V = jnp.zeros((k_max + 1, n, B), dtype).at[0].set(
        jnp.where(rho0 > 0, r / rho0, r))
    H = jnp.zeros((k_max + 1, k_max, B), dtype)
    g = jnp.zeros((k_max + 1, B), dtype).at[0].set(rho0)
    cs = jnp.zeros((k_max, B), dtype)
    sn = jnp.zeros((k_max, B), dtype)

    class Carry(NamedTuple):
        k: jnp.ndarray
        k_lane: jnp.ndarray  # [B] per-lane freeze iteration
        V: jnp.ndarray
        H: jnp.ndarray
        g: jnp.ndarray
        cs: jnp.ndarray
        sn: jnp.ndarray
        rho: jnp.ndarray   # [B]

    def cond(c: Carry):
        return jnp.any(c.rho > eps * b_norm) & (c.k < k_max)

    def body(c: Carry):
        k = c.k
        act = c.rho > eps * b_norm                       # [B]
        w = Amul(c.V[k])                                 # [n, B]
        Avk_norm = jnp.linalg.norm(w, axis=0)

        def mgs(j, carry):
            w, hcol = carry
            on = j <= k
            h = jnp.where(on, jnp.sum(w * c.V[j], axis=0), 0.0)
            w = w - h[None, :] * c.V[j]
            return (w, hcol.at[j].set(h))

        w, hcol = lax.fori_loop(0, k_max + 1, mgs,
                                (w, jnp.zeros((k_max + 1, B), dtype)))
        new_norm = jnp.linalg.norm(w, axis=0)

        # conditional reorthogonalization, per lane (Gmres.h:117-130)
        need = (Avk_norm + 1e-3 * new_norm) == Avk_norm

        def mgs2(j, carry):
            w, hcol = carry
            on = j <= k
            h = jnp.where(on & need, jnp.sum(w * c.V[j], axis=0), 0.0)
            w = w - h[None, :] * c.V[j]
            return (w, hcol.at[j].add(h))

        w, hcol = lax.fori_loop(0, k_max + 1, mgs2, (w, hcol))
        new_norm = jnp.where(need, jnp.linalg.norm(w, axis=0), new_norm)

        hcol = hcol.at[k + 1].set(new_norm)
        v_new = jnp.where(new_norm > 0, w / new_norm, w)
        V = c.V.at[k + 1].set(jnp.where(act, v_new, c.V[k + 1]))

        def rot(j, hcol):
            on = j < k
            h0, h1 = hcol[j], hcol[j + 1]
            cj = jnp.where(on, c.cs[j], 1.0)
            sj = jnp.where(on, c.sn[j], 0.0)
            return hcol.at[j].set(cj * h0 - sj * h1).at[j + 1].set(
                sj * h0 + cj * h1)

        hcol = lax.fori_loop(0, k_max, rot, hcol)

        nu = jnp.sqrt(hcol[k] ** 2 + hcol[k + 1] ** 2)
        ck = jnp.where(nu > 0, hcol[k] / nu, 1.0)
        sk = jnp.where(nu > 0, -hcol[k + 1] / nu, 0.0)
        hcol = hcol.at[k].set(ck * hcol[k] - sk * hcol[k + 1]).at[k + 1].set(0.0)

        g0, g1 = c.g[k], c.g[k + 1]
        gnew = c.g.at[k].set(jnp.where(act, ck * g0 - sk * g1, g0)).at[
            k + 1].set(jnp.where(act, sk * g0 + ck * g1, g1))
        rho = jnp.where(act, jnp.abs(gnew[k + 1]), c.rho)

        return Carry(
            k=k + 1,
            k_lane=jnp.where(act, k + 1, c.k_lane),
            V=V,
            H=c.H.at[:, k].set(jnp.where(act, hcol, c.H[:, k])),
            g=gnew,
            cs=c.cs.at[k].set(jnp.where(act, ck, c.cs[k])),
            sn=c.sn.at[k].set(jnp.where(act, sk, c.sn[k])),
            rho=rho,
        )

    out = lax.while_loop(cond, body,
                         Carry(jnp.int32(0), jnp.zeros((B,), jnp.int32),
                               V, H, g, cs, sn, rho0))

    # per-lane masked back-substitution, unrolled over the small k_max.
    # Each lane's Hessenberg/residual state froze at its OWN iteration
    # k_lane (H columns >= k_lane are untouched zeros for that lane), so
    # each lane solves its own truncation: rows >= k_lane get unit
    # diagonal / zero rhs -> y = 0, exactly the single-solver's masked
    # back-substitution (gmres.py:180-191) per lane.
    k_lane = out.k_lane                                  # [B]
    idx = jnp.arange(k_max)
    act_row = idx[:, None] < k_lane[None, :]             # [k_max, B]
    rhs = jnp.where(act_row, out.g[:k_max], 0.0)         # [k_max, B]
    y = [None] * k_max
    for i in reversed(range(k_max)):
        s = rhs[i]
        for j in range(i + 1, k_max):
            s = s - out.H[i, j] * y[j]
        lane_on = i < k_lane                             # [B]
        diag = jnp.where(lane_on, out.H[i, i], 1.0)
        y[i] = jnp.where(lane_on, s / diag, jnp.zeros_like(s))
    y = jnp.stack(y, axis=0)                             # [k_max, B]

    x = x0 + jnp.sum(out.V[:k_max] * y[:, None, :], axis=0)
    return x, k_lane, out.rho


def _calc_dhdu_list_bm(problem: ContinuousProblem, config: CgmresConfig,
                       t, x, u_list):
    """Batch-minor horizon sweep: x [dim_x, B], u_list [N, dim_uc, B]
    -> dhdu [N, dim_uc, B] (``CgmresSolver.cpp:146-183``)."""
    N = config.horizon_divide_num
    dtype = x.dtype
    ode = INTEGRATORS[config.ode_solver]

    f1 = lambda tau, xx, uc: problem.state_eq(tau, xx, uc[: problem.dim_u])
    f_bm = jax.vmap(f1, in_axes=(None, -1, -1), out_axes=-1)

    T = config.steady_horizon_duration * (
        1.0 - jnp.exp(-config.horizon_increase_ratio * t))
    h = T / N

    taus = t + h * jnp.arange(N, dtype=dtype)

    def fwd(xx, tu):
        tau, u = tu
        xn = ode(f_bm, tau, xx, u, h)
        return xn, xn

    xN, xs_tail = lax.scan(fwd, x, (taus, u_list))
    xs = jnp.concatenate([x[None], xs_tail], axis=0)     # [N+1, dim_x, B]

    lmd_N = jax.vmap(problem.dphi_dx_at, in_axes=(None, -1),
                     out_axes=-1)(t + T, xs[N])

    costate1 = lambda tau, lmd, xu: problem.costate_eq_at(
        tau, lmd, xu[: problem.dim_x], xu[problem.dim_x:])
    costate_bm = jax.vmap(costate1, in_axes=(None, -1, -1), out_axes=-1)

    def bwd(lmd_next, inp):
        tau_next, xx, u = inp
        xu = jnp.concatenate([xx, u], axis=0)
        lmd = ode(costate_bm, tau_next, lmd_next, xu, -h)
        return lmd, lmd_next

    taus_next = t + h * (1.0 + jnp.arange(N, dtype=dtype))
    _, lmd_next_list = lax.scan(bwd, lmd_N, (taus_next, xs[:-1], u_list),
                                reverse=True)

    dh1 = jax.vmap(problem.dh_du_at, in_axes=(None, -1, -1, -1), out_axes=-1)
    dhdu = jax.vmap(dh1)(taus, xs[:-1], u_list, lmd_next_list)
    return dhdu                                          # [N, dim_uc, B]


def _control_step_bm_core(problem: ContinuousProblem, config: CgmresConfig,
                          t, x, next_x, u_list, du_warm):
    """Batch-minor continuation-update body: x/next_x [dim_x, B],
    u_list [N, dim_uc, B], du_warm [N*dim_uc, B].
    Returns (u_list_new, du, err) in the same layout — no transposes, so
    callers that already hold batch-minor state (the fleet simulation scan)
    pay zero per-step layout cost."""
    N = config.horizon_divide_num
    dlt = config.finite_diff_delta
    dt = config.dt
    nuc = problem.dim_uc
    B = x.shape[-1]

    dhdu = _calc_dhdu_list_bm(problem, config, t, x, u_list)

    t_wd = t + dlt
    x_wd = (1.0 - dlt / dt) * x + (dlt / dt) * next_x
    dhdu_wd = _calc_dhdu_list_bm(problem, config, t_wd, x_wd, u_list)

    flat = lambda a: a.reshape(N * nuc, B)
    b = ((1.0 - config.eq_zeta * dlt) * flat(dhdu) - flat(dhdu_wd)) / dlt

    if config.use_jvp:
        def F(ul):
            return flat(_calc_dhdu_list_bm(problem, config, t_wd, x_wd, ul))

        def Amul(v):
            return jax.jvp(F, (u_list,), (v.reshape(N, nuc, B),))[1]
    else:
        def Amul(v):
            ul = u_list + dlt * v.reshape(N, nuc, B)
            dh = _calc_dhdu_list_bm(problem, config, t_wd, x_wd, ul)
            return (flat(dh) - flat(dhdu_wd)) / dlt

    du, _, _ = gmres_bm(Amul, b, du_warm, k_max=config.k_max, eps=1e-10)

    u_list_new = u_list + dt * du.reshape(N, nuc, B)
    err = jnp.sqrt(jnp.sum(dhdu**2, axis=(0, 1)))
    return u_list_new, du, err


def _control_step_bm(problem: ContinuousProblem, config: CgmresConfig,
                     t, xs_b, next_xs_b, states: CgmresState) -> CgmresState:
    """Batch-minor continuation update for a fleet of controllers.

    Public layout is batch-first (like ``control_step_batch``); the one-time
    boundary transposes bracket a loop-free body, so everything inside —
    sweeps, FD products, GMRES recurrences — runs with the batch on the
    vector lanes.
    """
    bm = lambda a: jnp.moveaxis(a, 0, -1)
    u_list_new, du, err = _control_step_bm_core(
        problem, config, t, bm(xs_b), bm(next_xs_b),
        bm(states.u_list), bm(states.delta_u_vec))
    bf = lambda a: jnp.moveaxis(a, -1, 0)
    return CgmresState(
        u_list=bf(u_list_new),
        delta_u_vec=bf(du),
        u=bf(u_list_new[0]),
        err=err,
    )


def _simulate(problem: ContinuousProblem, config: CgmresConfig,
              t0, x0, state: CgmresState, *, n_steps: int):
    """Closed-loop simulation as one on-device scan (``CgmresSolver::run``)."""
    sim_f = INTEGRATORS[config.sim_ode_solver]
    f = lambda t, x, u: problem.state_eq(t, x, u[: problem.dim_u])

    def step(carry, i):
        t, x, st = carry
        next_x = sim_f(f, t, x, st.u, config.dt)
        st = _control_step(problem, config, t, x, next_x, st)
        return (t + config.dt, next_x, st), (t, x, st.u, st.err)

    (_, _, _), (ts, xs, us, errs) = lax.scan(
        step, (t0, x0, state), jnp.arange(n_steps))
    return ts, xs, us, errs


def _simulate_bm(problem: ContinuousProblem, config: CgmresConfig,
                 t0, x0s_b, states: CgmresState, *, n_steps: int):
    """Batched closed-loop simulation on the lane-blocked fleet kernel.

    The r2 ``simulate_batch`` was vmap-of-single ``_simulate`` and never
    used the 8.5x lane-blocked step kernel; this scans
    :func:`_control_step_bm_core` directly with the batch-minor state held
    across steps, so the boundary transposes happen ONCE outside the scan
    (``CgmresSolver::run`` at fleet scale, ``CgmresSolver.cpp:66-109``).
    Returns batch-first (ts [B, n], xs [B, n, dim_x], us [B, n, dim_uc],
    errs [B, n]) — same contract as the old vmap path.
    """
    sim_f = INTEGRATORS[config.sim_ode_solver]
    f1 = lambda t, xx, u: problem.state_eq(t, xx, u[: problem.dim_u])
    f_bm = jax.vmap(f1, in_axes=(None, -1, -1), out_axes=-1)

    bm = lambda a: jnp.moveaxis(a, 0, -1)
    B = x0s_b.shape[0]
    x0 = bm(x0s_b)                                       # [dim_x, B]
    u_list0 = bm(states.u_list)                          # [N, dim_uc, B]
    du0 = bm(states.delta_u_vec)                         # [N*dim_uc, B]
    u0 = bm(states.u)                                    # [dim_uc, B]

    def step(carry, i):
        t, x, u_list, du, u = carry
        next_x = sim_f(f_bm, t, x, u, config.dt)
        u_list, du, err = _control_step_bm_core(
            problem, config, t, x, next_x, u_list, du)
        u_new = u_list[0]
        return ((t + config.dt, next_x, u_list, du, u_new),
                (t, x, u_new, err))

    _, (ts, xs, us, errs) = lax.scan(
        step, (t0, x0, u_list0, du0, u0), jnp.arange(n_steps))
    ts_b = jnp.broadcast_to(ts[None, :], (B, n_steps))
    return (ts_b, jnp.moveaxis(xs, -1, 0), jnp.moveaxis(us, -1, 0),
            jnp.moveaxis(errs, -1, 0))
