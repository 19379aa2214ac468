// Adaptive Dormand-Prince RK45 integrator with built-in plant dynamics.
//
// Native host-side analog of the reference's scipy.integrate.odeint (compiled
// LSODA) plant integration (simulation_class/model.py:61).  The simulator is
// the "real system" and runs on the host; this gives it a compiled, adaptive,
// double-precision integrator independent of scipy, callable from Python via
// ctypes (see native/__init__.py).
//
// C ABI:
//   int mcpilco_integrate(int system_id, double* x /*in-out, dim*/, int dim,
//                         double t0, double t1, const double* u, int u_dim,
//                         double rtol, double atol);
//   returns 0 on success, <0 on error (unknown system / step failure).
//
// Built-in systems (ids):
//   0 pendulum   [theta, theta_dot], torque input
//     (dynamics of simulation_class/ode_systems.py:16-31)
//   1 cartpole   [x, x_dot, theta, theta_dot], force input (:34-68)
//   2 furuta     [th_h, th_v, dth_h, dth_v], arm torque (envs/ode.py furuta)

#include <cmath>
#include <cstring>

namespace {

constexpr int kMaxDim = 16;

void pendulum(const double* y, double /*t*/, const double* u, double* dy) {
  const double m = 1.0, l = 1.0, b = 0.1, g = 9.81;
  const double inertia = m * l * l / 3.0;
  dy[0] = y[1];
  dy[1] = (u[0] - b * y[1] - 0.5 * m * l * g * std::sin(y[0])) / inertia;
}

void cartpole(const double* y, double /*t*/, const double* u, double* dy) {
  const double m1 = 0.5, m2 = 0.5, l = 0.5, b = 0.1, g = 9.81;
  const double xd = y[1], th = y[2], thd = y[3];
  const double s = std::sin(th), c = std::cos(th);
  const double f = u[0];
  const double den = 4.0 * (m1 + m2) - 3.0 * m2 * c * c;
  dy[0] = xd;
  dy[1] = (2.0 * m2 * l * thd * thd * s + 3.0 * m2 * g * s * c + 4.0 * f - 4.0 * b * xd) / den;
  dy[2] = thd;
  dy[3] = (-3.0 * m2 * l * thd * thd * s * c - 6.0 * (m1 + m2) * g * s - 6.0 * (f - b * xd) * c) /
          (l * den);
}

void furuta(const double* y, double /*t*/, const double* u, double* dy) {
  const double m_p = 0.024, L_a = 0.085, L_p = 0.129;
  const double J_a = 0.57e-4, J_p = 0.33e-4;
  const double b_a = 1e-4, b_p = 5e-5, g = 9.81;
  const double l_p = L_p / 2.0;
  const double J_pt = J_p + m_p * l_p * l_p;
  const double J_at = J_a + m_p * L_a * L_a;
  const double th_v = y[1], dth_h = y[2], dth_v = y[3];
  const double sv = std::sin(th_v), cv = std::cos(th_v);
  const double m11 = J_at + J_pt * sv * sv;
  const double m12 = m_p * l_p * L_a * cv;
  const double m22 = J_pt;
  const double c1 =
      J_pt * 2.0 * sv * cv * dth_h * dth_v - m_p * l_p * L_a * sv * dth_v * dth_v + b_a * dth_h;
  const double c2 = -J_pt * sv * cv * dth_h * dth_h + m_p * g * l_p * sv + b_p * dth_v;
  const double det = m11 * m22 - m12 * m12;
  const double r1 = u[0] - c1, r2 = -c2;
  dy[0] = dth_h;
  dy[1] = dth_v;
  dy[2] = (m22 * r1 - m12 * r2) / det;
  dy[3] = (-m12 * r1 + m11 * r2) / det;
}

using DynFn = void (*)(const double*, double, const double*, double*);

DynFn lookup(int system_id) {
  switch (system_id) {
    case 0: return pendulum;
    case 1: return cartpole;
    case 2: return furuta;
    default: return nullptr;
  }
}

// Dormand-Prince 5(4) coefficients.
const double kC[7] = {0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0, 1.0};
const double kA[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {1.0 / 5, 0, 0, 0, 0, 0},
    {3.0 / 40, 9.0 / 40, 0, 0, 0, 0},
    {44.0 / 45, -56.0 / 15, 32.0 / 9, 0, 0, 0},
    {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0, 0},
    {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656, 0},
    {35.0 / 384, 0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84},
};
const double kB5[7] = {35.0 / 384, 0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84, 0};
const double kB4[7] = {5179.0 / 57600,    0,           7571.0 / 16695, 393.0 / 640,
                       -92097.0 / 339200, 187.0 / 2100, 1.0 / 40};

}  // namespace

extern "C" int mcpilco_integrate(int system_id, double* x, int dim, double t0, double t1,
                                 const double* u, int u_dim, double rtol, double atol) {
  (void)u_dim;
  DynFn f = lookup(system_id);
  if (f == nullptr || dim <= 0 || dim > kMaxDim) return -1;
  if (t1 <= t0) return 0;

  double t = t0;
  double h = (t1 - t0) / 10.0;
  double k[7][kMaxDim];
  double y_tmp[kMaxDim], y5[kMaxDim], y4[kMaxDim];

  const int kMaxSteps = 100000;
  for (int step = 0; step < kMaxSteps && t < t1; ++step) {
    if (t + h > t1) h = t1 - t;

    f(x, t, u, k[0]);
    for (int s = 1; s < 7; ++s) {
      for (int i = 0; i < dim; ++i) {
        double acc = 0.0;
        for (int j = 0; j < s; ++j) acc += kA[s][j] * k[j][i];
        y_tmp[i] = x[i] + h * acc;
      }
      f(y_tmp, t + kC[s] * h, u, k[s]);
    }
    double err = 0.0;
    for (int i = 0; i < dim; ++i) {
      double a5 = 0.0, a4 = 0.0;
      for (int s = 0; s < 7; ++s) {
        a5 += kB5[s] * k[s][i];
        a4 += kB4[s] * k[s][i];
      }
      y5[i] = x[i] + h * a5;
      y4[i] = x[i] + h * a4;
      const double sc = atol + rtol * std::fmax(std::fabs(x[i]), std::fabs(y5[i]));
      const double e = (y5[i] - y4[i]) / sc;
      err += e * e;
    }
    err = std::sqrt(err / dim);

    if (err <= 1.0) {  // accept
      t += h;
      std::memcpy(x, y5, sizeof(double) * dim);
    }
    // PI-free step-size update with safety factor
    double fac = 0.9 * std::pow(err > 1e-12 ? err : 1e-12, -0.2);
    fac = std::fmin(5.0, std::fmax(0.2, fac));
    h *= fac;
    if (h < 1e-14) return -2;
  }
  return (t >= t1) ? 0 : -3;
}

extern "C" int mcpilco_rollout_interval_count() { return 3; }  // number of built-in systems
