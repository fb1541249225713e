// Native CPU backend: homogeneous self-dual interior-point LP solver.
//
// This framework's equivalent of pycllp's vendored Vanderbei C solver
// behind Cython (SURVEY.md §2.2; reference mount empty this build —
// SURVEY.md §0). Written from the HSD math (Andersen & Andersen /
// Xu–Hung–Ye, Mehrotra predictor-corrector) — the same algorithm as the
// JAX core in pycllp_jax/solvers/hsd.py, in f64, one instance per
// OpenMP task. Serves as a host-side oracle / small-batch fast path and
// exercises the framework's native-runtime layer.
//
// Problem form: min c'x  s.t.  Ax = b, x >= 0   (EqualityLP)
// Exposed C ABI: hsd_solve_batch (see header comment below).

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Work {
  int m, n;
  std::vector<double> M;     // m*m normal matrix / Cholesky factor
  std::vector<double> dinv;  // n
  std::vector<double> p, q, u, v;      // m or n scratch
  std::vector<double> r1, t1, t2;      // n, m, m
  std::vector<double> rp, rd;          // m, n
  std::vector<double> dx, dy, dz, dxa, dya, dza;
  explicit Work(int m_, int n_)
      : m(m_), n(n_), M(m_ * m_), dinv(n_), p(n_), q(m_), u(n_), v(m_),
        r1(n_), t1(m_), t2(m_), rp(m_), rd(n_),
        dx(n_), dy(m_), dz(n_), dxa(n_), dya(m_), dza(n_) {}
};

// y = A x  (A row-major m*n)
inline void mv(const double* A, const double* x, double* y, int m, int n) {
  for (int i = 0; i < m; ++i) {
    double s = 0.0;
    const double* Ai = A + (size_t)i * n;
    for (int j = 0; j < n; ++j) s += Ai[j] * x[j];
    y[i] = s;
  }
}

// y = A' x
inline void rmv(const double* A, const double* x, double* y, int m, int n) {
  std::memset(y, 0, sizeof(double) * n);
  for (int i = 0; i < m; ++i) {
    const double xi = x[i];
    const double* Ai = A + (size_t)i * n;
    for (int j = 0; j < n; ++j) y[j] += Ai[j] * xi;
  }
}

inline double dot(const double* a, const double* b, int k) {
  double s = 0.0;
  for (int i = 0; i < k; ++i) s += a[i] * b[i];
  return s;
}

inline double nrm2(const double* a, int k) { return std::sqrt(dot(a, a, k)); }

// Lower Cholesky in place; returns false on non-PSD pivot.
bool cholesky(double* M, int m) {
  for (int k = 0; k < m; ++k) {
    double akk = M[(size_t)k * m + k];
    for (int j = 0; j < k; ++j) {
      const double l = M[(size_t)k * m + j];
      akk -= l * l;
    }
    if (!(akk > 0.0)) return false;
    const double lkk = std::sqrt(akk);
    M[(size_t)k * m + k] = lkk;
    for (int i = k + 1; i < m; ++i) {
      double s = M[(size_t)i * m + k];
      const double* Li = M + (size_t)i * m;
      const double* Lk = M + (size_t)k * m;
      for (int j = 0; j < k; ++j) s -= Li[j] * Lk[j];
      M[(size_t)i * m + k] = s / lkk;
    }
  }
  return true;
}

// Solve L L' x = r in place (r overwritten by x).
void chol_solve(const double* L, double* r, int m) {
  for (int i = 0; i < m; ++i) {
    double s = r[i];
    const double* Li = L + (size_t)i * m;
    for (int j = 0; j < i; ++j) s -= Li[j] * r[j];
    r[i] = s / Li[i];
  }
  for (int i = m - 1; i >= 0; --i) {
    double s = r[i];
    for (int j = i + 1; j < m; ++j) s -= L[(size_t)j * m + i] * r[j];
    r[i] = s / L[(size_t)i * m + i];
  }
}

enum StatusCode {
  OPTIMAL = 0,
  ITER_LIMIT = 1,
  INFEASIBLE = 2,
  UNBOUNDED = 3,
  NUMERICAL = 4,
};

int solve_one(const double* A, const double* b, const double* c, int m, int n,
              double tol, int maxiter, double alpha0, double reg_eps, Work& w,
              double* x_out, double* y_out, double* obj, int* iters) {
  std::vector<double> x(n, 1.0), y(m, 0.0), z(n, 1.0);
  double tau = 1.0, kappa = 1.0;

  // initial residual norms for relative indicators
  mv(A, x.data(), w.t1.data(), m, n);
  for (int i = 0; i < m; ++i) w.rp[i] = b[i] - w.t1[i];
  rmv(A, y.data(), w.r1.data(), m, n);
  for (int j = 0; j < n; ++j) w.rd[j] = c[j] - w.r1[j] - z[j];
  const double rp0 = std::fmax(1.0, nrm2(w.rp.data(), m));
  const double rd0 = std::fmax(1.0, nrm2(w.rd.data(), n));
  const double rg0 = std::fmax(1.0, std::fabs(dot(c, x.data(), n) - dot(b, y.data(), m) + kappa));
  const double mu0 = (dot(x.data(), z.data(), n) + tau * kappa) / (n + 1);

  int it = 0;
  for (; it < maxiter; ++it) {
    // residuals
    mv(A, x.data(), w.t1.data(), m, n);
    for (int i = 0; i < m; ++i) w.rp[i] = b[i] * tau - w.t1[i];
    rmv(A, y.data(), w.r1.data(), m, n);
    for (int j = 0; j < n; ++j) w.rd[j] = c[j] * tau - w.r1[j] - z[j];
    const double cx = dot(c, x.data(), n), by = dot(b, y.data(), m);
    const double rg = cx - by + kappa;
    const double mu = (dot(x.data(), z.data(), n) + tau * kappa) / (n + 1);

    // termination
    const double rho_p = nrm2(w.rp.data(), m) / rp0;
    const double rho_d = nrm2(w.rd.data(), n) / rd0;
    const double rho_g = std::fabs(rg) / rg0;
    const double rho_mu = mu / mu0;
    const double rho_A = std::fabs(cx - by) / (tau + std::fabs(by));
    if (rho_p <= tol && rho_d <= tol && rho_A <= tol) break;
    const bool inf1 = rho_p <= tol && rho_d <= tol && rho_g <= tol &&
                      tau <= tol * std::fmax(1.0, kappa);
    const bool inf2 = rho_mu <= tol && tau <= tol * std::fmin(1.0, kappa);
    if (inf1 || inf2) {
      *iters = it;
      return by > tol ? INFEASIBLE : UNBOUNDED;
    }

    // normal matrix M = A D A' + reg I
    for (int j = 0; j < n; ++j) w.dinv[j] = x[j] / z[j];
    double diag_max = 0.0;
    for (int i = 0; i < m; ++i) {
      const double* Ai = A + (size_t)i * n;
      for (int k = i; k < m; ++k) {
        const double* Ak = A + (size_t)k * n;
        double s = 0.0;
        for (int j = 0; j < n; ++j) s += Ai[j] * w.dinv[j] * Ak[j];
        w.M[(size_t)i * m + k] = s;
        w.M[(size_t)k * m + i] = s;
        if (k == i && s > diag_max) diag_max = s;
      }
    }
    const double reg = reg_eps * diag_max;
    for (int i = 0; i < m; ++i) w.M[(size_t)i * m + i] += reg;
    if (!cholesky(w.M.data(), m)) {
      *iters = it;
      return NUMERICAL;
    }

    // (p, q): solve for the tau column
    for (int j = 0; j < n; ++j) w.p[j] = w.dinv[j] * c[j];
    mv(A, w.p.data(), w.q.data(), m, n);
    for (int i = 0; i < m; ++i) w.q[i] += b[i];
    chol_solve(w.M.data(), w.q.data(), m);
    rmv(A, w.q.data(), w.p.data(), m, n);
    for (int j = 0; j < n; ++j) w.p[j] = w.dinv[j] * (w.p[j] - c[j]);
    const double denom = kappa / tau + dot(b, w.q.data(), m) - dot(c, w.p.data(), n);

    double dtau = 0.0, dkappa = 0.0;
    auto newton = [&](double eta, double gmu, const double* dxa,
                      const double* dza, double dta, double dka, double* dx,
                      double* dy, double* dz, double& dt, double& dk) {
      // r1 = eta*rd - rxs/x ; rxs = gmu - x z - dxa dza
      for (int j = 0; j < n; ++j) {
        const double rxs = gmu - x[j] * z[j] - (dxa ? dxa[j] * dza[j] : 0.0);
        w.r1[j] = eta * w.rd[j] - rxs / x[j];
        w.u[j] = w.dinv[j] * w.r1[j];
      }
      mv(A, w.u.data(), w.v.data(), m, n);
      for (int i = 0; i < m; ++i) w.v[i] += eta * w.rp[i];
      chol_solve(w.M.data(), w.v.data(), m);  // v = M^-1 (eta rp + A D r1)
      rmv(A, w.v.data(), w.u.data(), m, n);
      for (int j = 0; j < n; ++j) w.u[j] = w.dinv[j] * (w.u[j] - w.r1[j]);
      const double rtk = gmu - tau * kappa - (dxa ? dta * dka : 0.0);
      dt = (eta * rg + rtk / tau -
            (dot(b, w.v.data(), m) - dot(c, w.u.data(), n))) /
           denom;
      for (int j = 0; j < n; ++j) dx[j] = w.u[j] + w.p[j] * dt;
      for (int i = 0; i < m; ++i) dy[i] = w.v[i] + w.q[i] * dt;
      for (int j = 0; j < n; ++j) {
        const double rxs = gmu - x[j] * z[j] - (dxa ? dxa[j] * dza[j] : 0.0);
        dz[j] = (rxs - z[j] * dx[j]) / x[j];
      }
      dk = (rtk - kappa * dt) / tau;
    };

    auto max_step = [&](const double* dx, const double* dz, double dt,
                        double dk) {
      double a = 1e300;
      for (int j = 0; j < n; ++j) {
        if (dx[j] < 0) a = std::fmin(a, -x[j] / dx[j]);
        if (dz[j] < 0) a = std::fmin(a, -z[j] / dz[j]);
      }
      if (dt < 0) a = std::fmin(a, -tau / dt);
      if (dk < 0) a = std::fmin(a, -kappa / dk);
      return a;
    };

    // predictor
    double dta, dka;
    newton(1.0, 0.0, nullptr, nullptr, 0, 0, w.dxa.data(), w.dya.data(),
           w.dza.data(), dta, dka);
    const double a_aff = std::fmin(1.0, max_step(w.dxa.data(), w.dza.data(), dta, dka));
    double mu_aff = (tau + a_aff * dta) * (kappa + a_aff * dka);
    for (int j = 0; j < n; ++j)
      mu_aff += (x[j] + a_aff * w.dxa[j]) * (z[j] + a_aff * w.dza[j]);
    mu_aff /= (n + 1);
    double gamma = mu_aff / mu;
    gamma = gamma * gamma * gamma;
    if (gamma < 0) gamma = 0;
    if (gamma > 1) gamma = 1;

    // corrector
    newton(1.0 - gamma, gamma * mu, w.dxa.data(), w.dza.data(), dta, dka,
           w.dx.data(), w.dy.data(), w.dz.data(), dtau, dkappa);
    const double alpha =
        std::fmin(1.0, alpha0 * max_step(w.dx.data(), w.dz.data(), dtau, dkappa));
    for (int j = 0; j < n; ++j) x[j] += alpha * w.dx[j];
    for (int i = 0; i < m; ++i) y[i] += alpha * w.dy[i];
    for (int j = 0; j < n; ++j) z[j] += alpha * w.dz[j];
    tau += alpha * dtau;
    kappa += alpha * dkappa;
    if (!(tau > 0) || !std::isfinite(tau) || !std::isfinite(kappa)) {
      *iters = it;
      return NUMERICAL;
    }
  }

  *iters = it;
  const double ts = tau > 1e-300 ? tau : 1e-300;
  for (int j = 0; j < n; ++j) x_out[j] = x[j] / ts;
  for (int i = 0; i < m; ++i) y_out[i] = y[i] / ts;
  *obj = dot(c, x_out, n);
  return it < maxiter ? OPTIMAL : ITER_LIMIT;
}

}  // namespace

extern "C" {

// Batched solve: A (m*n, row-major, shared), b (B*m), c (B*n).
// Outputs: x (B*n), y (B*m), obj (B), status (B), iters (B).
// Returns 0 on success (individual failures land in status[]).
int hsd_solve_batch(const double* A, const double* b, const double* c, int m,
                    int n, int B, double tol, int maxiter, double alpha0,
                    double reg_eps, double* x, double* y, double* obj,
                    int* status, int* iters) {
#ifdef _OPENMP
#pragma omp parallel
  {
    Work w(m, n);
#pragma omp for schedule(dynamic)
    for (int i = 0; i < B; ++i) {
      status[i] = solve_one(A, b + (size_t)i * m, c + (size_t)i * n, m, n, tol,
                            maxiter, alpha0, reg_eps, w, x + (size_t)i * n,
                            y + (size_t)i * m, obj + i, iters + i);
    }
  }
#else
  Work w(m, n);
  for (int i = 0; i < B; ++i) {
    status[i] = solve_one(A, b + (size_t)i * m, c + (size_t)i * n, m, n, tol,
                          maxiter, alpha0, reg_eps, w, x + (size_t)i * n,
                          y + (size_t)i * m, obj + i, iters + i);
  }
#endif
  return 0;
}

int hsd_native_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
