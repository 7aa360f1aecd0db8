// nmpc_runtime — native real-time MPC executor.
//
// The reference's asynchronous MPC driver is C++/ROS: a simulation loop at
// sim_dt with an MPC timer at mpc_dt, and (in the FMPC variant) affine
// feedback u = u0 + K (x - x_pred) applied between solves
// (nmpc_ddp/tests/src/TestDDPCartPole.cpp:299-347,
//  nmpc_fmpc/tests/src/TestFmpcCartPole.cpp:345-356).
//
// This is the framework's equivalent as a standalone native runtime:
//  * a seqlock "latest control packet" buffer connecting the solver thread
//    to the control thread without locks on the hot path,
//  * a control thread stepping the plant at sim_dt and applying the packet's
//    affine feedback (native gemv, microsecond latency),
//  * an MPC thread invoking the (Python/JAX) solver via a C callback at
//    mpc_dt, recording solve latencies and deadline misses,
//  * a deterministic single-threaded virtual-time mode for testing, and a
//    threaded real-time mode (clock_nanosleep pacing).
//
// Exposed through a plain C API consumed via ctypes
// (nmpc_tpu/runtime/executor.py). No Python dependencies here.

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr int kMaxDim = 32;

// Control packet published by the MPC thread.
struct ControlPacket {
  double t_solve = 0.0;            // time the packet's prediction refers to
  double u_ff[kMaxDim] = {0};      // feedforward input u0
  double K[kMaxDim * kMaxDim] = {0};  // feedback gain [nu x nx]
  double x_pred[kMaxDim] = {0};    // predicted state the gain is about
  int valid = 0;
};

// Seqlock single-writer multi-reader latest-value buffer.
class SeqlockBuffer {
 public:
  void write(const ControlPacket& p) {
    uint64_t s = seq_.load(std::memory_order_relaxed);
    seq_.store(s + 1, std::memory_order_release);  // odd: write in progress
    std::atomic_thread_fence(std::memory_order_acq_rel);
    data_ = p;
    std::atomic_thread_fence(std::memory_order_acq_rel);
    seq_.store(s + 2, std::memory_order_release);
  }
  bool read(ControlPacket* out) const {
    for (int attempt = 0; attempt < 64; ++attempt) {
      uint64_t s1 = seq_.load(std::memory_order_acquire);
      if (s1 & 1) continue;
      std::atomic_thread_fence(std::memory_order_acquire);
      ControlPacket p = data_;
      std::atomic_thread_fence(std::memory_order_acquire);
      uint64_t s2 = seq_.load(std::memory_order_acquire);
      if (s1 == s2) {
        *out = p;
        return p.valid != 0;
      }
    }
    return false;
  }

 private:
  std::atomic<uint64_t> seq_{0};
  ControlPacket data_;
};

// Built-in cart-pole plant (TestDDPCartPole.cpp:68-98 family).
struct CartPoleParam {
  double m1 = 1.0, m2 = 0.5, l = 2.0;
  static constexpr double g = 9.80665;
};

void cartpole_xdot(const CartPoleParam& p, const double* x, double f,
                   double* xdot) {
  double th = x[1], vel = x[2], om = x[3];
  double s = std::sin(th), c = std::cos(th);
  double denom = p.m1 + p.m2 * s * s;
  xdot[0] = vel;
  xdot[1] = om;
  xdot[2] = (f - p.m2 * p.l * om * om * s + p.m2 * CartPoleParam::g * s * c) / denom;
  xdot[3] = (f * c - p.m2 * p.l * om * om * s * c +
             CartPoleParam::g * (p.m1 + p.m2) * s) /
            (p.l * denom);
}

struct LatencyStats {
  std::vector<double> samples_ms;
  long deadline_misses = 0;

  void add(double ms, double budget_ms) {
    samples_ms.push_back(ms);
    if (ms > budget_ms) deadline_misses++;
  }
  double percentile(double p) const {
    if (samples_ms.empty()) return 0.0;
    std::vector<double> s = samples_ms;
    std::sort(s.begin(), s.end());
    size_t idx = static_cast<size_t>(p * (s.size() - 1));
    return s[idx];
  }
};

using SolveCallback = int (*)(double t, const double* x, double* u_ff,
                              double* K, double* x_pred);

struct Executor {
  int nx = 4, nu = 1;
  double sim_dt = 0.002;
  double mpc_dt = 0.004;
  double u_min = -1e30, u_max = 1e30;
  bool use_feedback = true;
  CartPoleParam plant;
  std::vector<double> x;
  SeqlockBuffer buffer;
  LatencyStats stats;
  // trajectory log
  std::vector<double> log_t, log_x, log_u;
  long n_solves = 0;

  void plant_step(double u) {
    // RK4 on the built-in plant (OdeSolver.h:53-73 equivalent)
    double k1[4], k2[4], k3[4], k4[4], tmp[4];
    cartpole_xdot(plant, x.data(), u, k1);
    for (int i = 0; i < 4; i++) tmp[i] = x[i] + 0.5 * sim_dt * k1[i];
    cartpole_xdot(plant, tmp, u, k2);
    for (int i = 0; i < 4; i++) tmp[i] = x[i] + 0.5 * sim_dt * k2[i];
    cartpole_xdot(plant, tmp, u, k3);
    for (int i = 0; i < 4; i++) tmp[i] = x[i] + sim_dt * k3[i];
    cartpole_xdot(plant, tmp, u, k4);
    for (int i = 0; i < 4; i++)
      x[i] += sim_dt / 6.0 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]);
  }

  double control_from_packet(const ControlPacket& p) {
    // u = u_ff + K (x - x_pred), clamped (TestDDPCartPole.cpp:394)
    double u = p.u_ff[0];
    if (use_feedback) {
      for (int j = 0; j < nx; j++) u += p.K[j] * (x[j] - p.x_pred[j]);
    }
    return std::min(std::max(u, u_min), u_max);
  }

  // Deterministic single-threaded virtual-time run: control steps at sim_dt,
  // MPC solve every round(mpc_dt/sim_dt) steps (synchronous).
  int run_virtual(SolveCallback solve, double duration) {
    int steps = static_cast<int>(duration / sim_dt);
    int mpc_every = std::max(1, static_cast<int>(std::lround(mpc_dt / sim_dt)));
    double t = 0.0;
    for (int i = 0; i < steps; i++) {
      if (i % mpc_every == 0) {
        ControlPacket p;
        auto start = std::chrono::steady_clock::now();
        int rc = solve(t, x.data(), p.u_ff, p.K, p.x_pred);
        double ms = std::chrono::duration<double, std::milli>(
                        std::chrono::steady_clock::now() - start)
                        .count();
        stats.add(ms, mpc_dt * 1e3);
        n_solves++;
        if (rc < 0) return rc;
        p.t_solve = t;
        p.valid = 1;
        buffer.write(p);
      }
      ControlPacket p;
      double u = buffer.read(&p) ? control_from_packet(p) : 0.0;
      log_t.push_back(t);
      log_x.insert(log_x.end(), x.begin(), x.end());
      log_u.push_back(u);
      plant_step(u);
      t += sim_dt;
    }
    return 0;
  }

  // Threaded real-time run: control thread paced at sim_dt; MPC thread
  // solves as fast as it can, paced to mpc_dt.
  int run_realtime(SolveCallback solve, double duration) {
    std::atomic<bool> stop{false};
    std::atomic<int> solve_rc{0};

    std::thread mpc([&] {
      auto next = std::chrono::steady_clock::now();
      double t0 = 0.0;
      auto start_wall = std::chrono::steady_clock::now();
      while (!stop.load(std::memory_order_relaxed)) {
        double t = std::chrono::duration<double>(
                       std::chrono::steady_clock::now() - start_wall)
                       .count();
        ControlPacket p;
        double x_snap[kMaxDim];
        {
          // snapshot state (racy read is fine for MPC purposes; the control
          // thread owns x — we read via the log-free seq below)
          std::memcpy(x_snap, x.data(), nx * sizeof(double));
        }
        auto s0 = std::chrono::steady_clock::now();
        int rc = solve(t0 + t, x_snap, p.u_ff, p.K, p.x_pred);
        double ms = std::chrono::duration<double, std::milli>(
                        std::chrono::steady_clock::now() - s0)
                        .count();
        stats.add(ms, mpc_dt * 1e3);
        n_solves++;
        if (rc < 0) {
          solve_rc.store(rc);
          return;
        }
        p.t_solve = t;
        p.valid = 1;
        buffer.write(p);
        next += std::chrono::duration_cast<std::chrono::steady_clock::duration>(
            std::chrono::duration<double>(mpc_dt));
        std::this_thread::sleep_until(next);
      }
    });

    auto next = std::chrono::steady_clock::now();
    int steps = static_cast<int>(duration / sim_dt);
    double t = 0.0;
    for (int i = 0; i < steps && solve_rc.load() == 0; i++) {
      ControlPacket p;
      double u = buffer.read(&p) ? control_from_packet(p) : 0.0;
      log_t.push_back(t);
      log_x.insert(log_x.end(), x.begin(), x.end());
      log_u.push_back(u);
      plant_step(u);
      t += sim_dt;
      next += std::chrono::duration_cast<std::chrono::steady_clock::duration>(
          std::chrono::duration<double>(sim_dt));
      std::this_thread::sleep_until(next);
    }
    stop.store(true);
    mpc.join();
    return solve_rc.load();
  }
};

}  // namespace

extern "C" {

Executor* nmpc_executor_create(int nx, int nu, double sim_dt, double mpc_dt) {
  if (nx <= 0 || nx > kMaxDim || nu <= 0 || nu > kMaxDim) return nullptr;
  auto* e = new Executor();
  e->nx = nx;
  e->nu = nu;
  e->sim_dt = sim_dt;
  e->mpc_dt = mpc_dt;
  e->x.assign(nx, 0.0);
  return e;
}

void nmpc_executor_destroy(Executor* e) { delete e; }

void nmpc_executor_set_cartpole_plant(Executor* e, double m1, double m2,
                                      double l, const double* x0) {
  e->plant.m1 = m1;
  e->plant.m2 = m2;
  e->plant.l = l;
  std::memcpy(e->x.data(), x0, e->nx * sizeof(double));
}

void nmpc_executor_set_input_limits(Executor* e, double lo, double hi) {
  e->u_min = lo;
  e->u_max = hi;
}

void nmpc_executor_set_feedback(Executor* e, int enabled) {
  e->use_feedback = enabled != 0;
}

int nmpc_executor_run(Executor* e, SolveCallback solve, double duration,
                      int realtime) {
  return realtime ? e->run_realtime(solve, duration)
                  : e->run_virtual(solve, duration);
}

long nmpc_executor_log_size(Executor* e) {
  return static_cast<long>(e->log_t.size());
}

void nmpc_executor_get_log(Executor* e, double* ts, double* xs, double* us) {
  std::memcpy(ts, e->log_t.data(), e->log_t.size() * sizeof(double));
  std::memcpy(xs, e->log_x.data(), e->log_x.size() * sizeof(double));
  std::memcpy(us, e->log_u.data(), e->log_u.size() * sizeof(double));
}

void nmpc_executor_get_state(Executor* e, double* x) {
  std::memcpy(x, e->x.data(), e->nx * sizeof(double));
}

void nmpc_executor_stats(Executor* e, double* p50_ms, double* p99_ms,
                         double* max_ms, long* n_solves,
                         long* deadline_misses) {
  *p50_ms = e->stats.percentile(0.50);
  *p99_ms = e->stats.percentile(0.99);
  *max_ms = e->stats.samples_ms.empty()
                ? 0.0
                : *std::max_element(e->stats.samples_ms.begin(),
                                    e->stats.samples_ms.end());
  *n_solves = e->n_solves;
  *deadline_misses = e->stats.deadline_misses;
}

}  // extern "C"
