"""Roofline audit of the fused lane kernels on the GPU.

For each kernel the algorithm's bytes (stage fields read, gains written)
and FLOPs per call are computed from the shapes (``*_kernel_model``), the
least time the card could take is the larger of bytes / peak bandwidth
and FLOPs / peak FP32 rate, and the roofline share is that least time
over the measured kernel time.  The kernels are elementwise over lanes
(no matrix products), so the compute peak is the fp32 CUDA-core rate,
not a tensor-core rate.

Peaks are keyed by ``device_kind``; a device not in the table is an
error.  Run on the GPU:  python benchmarks/roofline.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# Published dense peaks per device (NVIDIA H100 data sheet, SXM part, at
# the full 700 W power limit): HBM3 bandwidth and the fp32 rate of the
# CUDA cores.  A card set to a lower power limit cannot hold its top clock.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def peaks(device_kind: str) -> dict:
    """Peak table row for ``device_kind``; unknown devices raise."""
    if device_kind not in PEAKS:
        raise KeyError(f"no peak figures for device kind {device_kind!r}; "
                       f"add its data-sheet row to PEAKS")
    return PEAKS[device_kind]


def ddp_kernel_model(nx, nu, N, B):
    """Bytes + FLOPs per backward_pallas call."""
    in_floats = (2 * nx * nx + 2 * nx * nu + nx + 2 * nu + nu * nu)
    #            Fx,Lxx       Fu,Lxu       Lx   Lu+k    Luu
    out_floats = nu + nu * nx                       # k, K
    carry = 0                                       # in registers
    bytes_total = (in_floats + out_floats + carry) * 4 * N * B
    # per-stage flops (matmul chains on nx/nu-sized tiles, per lane):
    # Qu,Qx (2 mat-vec), FuT Vxx (nx*nx*nu), Qux/Quu/Qxx (3 mats),
    # cholesky nu^3/3, solves nu^2*(nx+1), value update ~4 nx^2 nu
    f = (2 * nx * nx + 2 * nx * nu                      # mat-vecs
         + 2 * nx * nx * nu + 2 * nx * nu * nu          # FuT Vxx, Quu
         + 2 * nx * nx * nx                             # Qxx
         + nu ** 3 // 3 + 2 * nu * nu * (nx + 1)        # chol + solves
         + 6 * nx * nx * nu + 2 * nx * nu)              # value recursion
    flops_total = 2 * f * N * B
    return bytes_total, flops_total


def fmpc_kernel_model(nx, nu, ng, N, B):
    in_floats = (2 * nx * nx + 2 * nx * nu + ng * nx + ng * nu + nu * nu
                 + 2 * nx + nu + 2 * ng + nx + nx)
    out_floats = nu + nu * nx + nx + nx * nx
    bytes_total = (in_floats + out_floats) * 4 * N * B
    f = (2 * ng * nx * nx + 2 * ng * nu * nu + 2 * ng * nx * nu  # condense
         + 4 * nx * nx * nx + 4 * nx * nx * nu                   # F,H,G,PA
         + nu ** 3 // 3 + 2 * nu * nu * (nx + 1)                 # chol+solve
         + 6 * nx * nx * nu + 4 * nx * nx)                       # value rec
    flops_total = 2 * f * N * B
    return bytes_total, flops_total


def audit(name, bytes_total, flops_total, measured_s, device_kind):
    pk = peaks(device_kind)
    t_mem = bytes_total / pk["hbm_bytes_per_s"]
    t_cmp = flops_total / pk["fp32_flops_per_s"]
    bound = "memory" if t_mem >= t_cmp else "compute"
    return {
        "kernel": name,
        "device_kind": device_kind,
        "bytes_MB": bytes_total / 1e6,
        "flops_M": flops_total / 1e6,
        "least_time_memory_us": t_mem * 1e6,
        "least_time_compute_us": t_cmp * 1e6,
        "binding_roofline": bound,
        "measured_us": measured_s * 1e6,
        "roofline_share": max(t_mem, t_cmp) / measured_s,
    }


def main():
    from benchmarks import parity_gate as G
    from benchmarks.timing import median_time
    from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas
    from nmpc_tpu.kernels.fmpc_backward_pallas import backward_fmpc_pallas
    from nmpc_tpu.models.cartpole import make_cartpole_fmpc_problem
    from nmpc_tpu.models.oscillator import make_oscillator_problem
    from nmpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    kind = jax.devices()[0].device_kind
    if jax.devices()[0].platform != "gpu":
        sys.exit("roofline.py measures the GPU")
    out = []
    N = 100

    # DDP fused backward, cart-pole at the headline shape
    B = 4096
    c, S, VxT, VxxT, lam = G._ddp_unconstrained_case(B, N)
    t = median_time(jax.jit(lambda *a: backward_pallas(c, *a)),
                    S, VxT, VxxT, lam)
    b, f = ddp_kernel_model(4, 1, N, B)
    out.append(audit(f"ddp_backward[cartpole B={B} N={N}]", b, f, t, kind))

    # FMPC fused backward at both served shapes
    for name, problem, B in (
            ("cartpole", make_cartpole_fmpc_problem(0.01), 4096),
            ("oscillator", make_oscillator_problem(0.01), 1024)):
        p, cf, co, var, gms, eps = G._fmpc_case(problem, B, N)
        f_pl = jax.jit(lambda co, ss, nus, eps, p=p, cf=cf, gms=gms:
                       backward_fmpc_pallas(p, cf, co, ss, nus, gms, eps))
        t = median_time(f_pl, co, var.ss, var.nus, eps)
        b, f = fmpc_kernel_model(p.state_dim, p.input_dim, p.ineq_dim, N, B)
        out.append(audit(f"fmpc_backward[{name} B={B} N={N}]", b, f, t,
                         kind))

    for r_ in out:
        print(json.dumps(r_))


if __name__ == "__main__":
    main()
