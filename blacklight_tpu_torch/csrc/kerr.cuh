// Kerr-Schild geometry for one ray, templated on the working type T
// (float or double).
//
// Device counterparts of blacklight_tpu/ops/geometry.py: radius
// (:36-53), ks_derivatives_c (:243-272), geodesic_rhs_c (:275-315) and
// renormalize_factor_c (:340-366), plus the Dormand-Prince RK5(4)7M
// tableau of blacklight_tpu/ops/geodesic.py:42-63.
//
// Every constant is written as T(...) so that float code never promotes
// to double. A constant numerator is written (1 / t) * s, the form in
// which PyTorch evaluates s / t, so that the plain PyTorch version of the
// kernel rounds alike. Scalars that the JAX package folds in Python double before
// they meet a float32 array (a^2, 2a, 2a^2, 3a^2, 2M) arrive precomputed
// on the host in KerrConsts.
#pragma once

#include <math.h>

namespace bl {

// ---- math overloads (no silent float -> double promotion) ----------------
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_hypot(float x, float y) { return hypotf(x, y); }
__device__ __forceinline__ double m_hypot(double x, double y) { return hypot(x, y); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double m_expm1(double x) { return expm1(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_sinh(float x) { return sinhf(x); }
__device__ __forceinline__ double m_sinh(double x) { return sinh(x); }
__device__ __forceinline__ float m_cosh(float x) { return coshf(x); }
__device__ __forceinline__ double m_cosh(double x) { return cosh(x); }
__device__ __forceinline__ float m_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double m_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_acos(float x) { return acosf(x); }
__device__ __forceinline__ double m_acos(double x) { return acos(x); }
__device__ __forceinline__ float m_atan(float x) { return atanf(x); }
__device__ __forceinline__ double m_atan(double x) { return atan(x); }
__device__ __forceinline__ float m_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double m_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_copysign(float x, float y) { return copysignf(x, y); }
__device__ __forceinline__ double m_copysign(double x, double y) { return copysign(x, y); }
__device__ __forceinline__ bool m_isinf(float x) { return isinf(x); }
__device__ __forceinline__ bool m_isinf(double x) { return isinf(x); }
__device__ __forceinline__ bool m_isfinite(float x) { return isfinite(x); }
__device__ __forceinline__ bool m_isfinite(double x) { return isfinite(x); }
__device__ __forceinline__ bool m_isnan(float x) { return isnan(x); }
__device__ __forceinline__ bool m_isnan(double x) { return isnan(x); }

// XLA's maximum/minimum propagate NaN; fmax/fmin would drop it.
template <typename T>
__device__ __forceinline__ T jmax(T a, T b) { return (a > b || m_isnan(a)) ? a : b; }
template <typename T>
__device__ __forceinline__ T jmin(T a, T b) { return (a < b || m_isnan(a)) ? a : b; }

// ---- Dormand-Prince RK5(4)7M (1980 JCoAM 6 19; geodesics.cpp:42-72) ------
// tests/test_torch_formula_kernel.py reads these literals and checks them
// against blacklight_tpu.ops.geodesic._DP_*.
constexpr double DP_ERR_POWER = 0.2;
constexpr double DP_ERR_FACTOR = 0.9;
constexpr double DP_MIN_FACTOR = 0.2;
constexpr double DP_MAX_FACTOR = 10.0;

// ---- Kerr-Schild constants of one launch ---------------------------------
template <typename T>
struct KerrConsts {
  T spin, a2, two_spin, two_a2, three_a2, two_mass;
  bool flat;
};

// |x|^2, r^2 and r at (x, y, z) (geometry.py:36-53): computed once where
// several quantities at one point need them.
template <typename T>
struct KsRadius {
  T rr2, r2, r;
};

template <typename T>
__device__ __forceinline__ KsRadius<T> ks_radius_parts(T x1, T x2, T x3,
                                                       const KerrConsts<T>& g) {
  KsRadius<T> q;
  q.rr2 = x1 * x1 + x2 * x2 + x3 * x3;
  q.r2 = T(0.5) * (q.rr2 - g.a2 + m_hypot(q.rr2 - g.a2, g.two_spin * x3));
  q.r = m_sqrt(q.r2);
  return q;
}

// r(x, y, z) (geometry.py:36-53)
template <typename T>
__device__ __forceinline__ T ks_radius(T x1, T x2, T x3, const KerrConsts<T>& g) {
  return ks_radius_parts(x1, x2, x3, g).r;
}

// The Kerr-Schild scalar f and the spatial covector l_i (l_0 = 1) at a
// point of radius q (geometry.py ks_scalars), and r^2 + a^2.
template <typename T>
struct KsScalars {
  T f, denom, l1, l2, l3;
};

template <typename T>
__device__ __forceinline__ KsScalars<T> ks_scalars(T x1, T x2, T x3, const KsRadius<T>& q,
                                                   const KerrConsts<T>& g) {
  const T r2 = q.r2, r = q.r;
  KsScalars<T> s;
  s.f = g.two_mass * r2 * r / (r2 * r2 + g.a2 * x3 * x3);
  s.denom = r2 + g.a2;
  s.l1 = (r * x1 + g.spin * x2) / s.denom;
  s.l2 = (r * x2 - g.spin * x1) / s.denom;
  s.l3 = x3 / r;
  return s;
}

// Kerr-Schild scalars at a point and their spatial derivatives
// (geometry.py ks_derivatives_c): f, the spatial covector l_i (l_0 = 1),
// df/dx^j and dl[i][j] = d l_i / dx^j.
template <typename T>
struct KsDerivs {
  T r, f, l1, l2, l3, df1, df2, df3;
  T dl[3][3];
};

template <typename T>
__device__ __forceinline__ void ks_derivatives(T x1, T x2, T x3, const KerrConsts<T>& g,
                                               KsDerivs<T>& d) {
  const T spin = g.spin, a2 = g.a2;
  const KsRadius<T> q = ks_radius_parts(x1, x2, x3, g);
  const T rr2 = q.rr2, r2 = q.r2, r = q.r;
  const KsScalars<T> s = ks_scalars(x1, x2, x3, q, g);
  const T f = s.f, denom = s.denom, l1 = s.l1, l2 = s.l2, l3 = s.l3;

  const T dr_denom = T(2) * r2 - rr2 + a2;
  const T dr_dx = r * x1 / dr_denom;
  const T dr_dy = r * x2 / dr_denom;
  const T dr_dz = (r * x3 + a2 * x3 / r) / dr_denom;
  const T f_denom = r * (r2 * r2 + a2 * x3 * x3);
  const T poly = r2 * r2 - g.three_a2 * x3 * x3;
  d.df1 = -poly * dr_dx / f_denom * f;
  d.df2 = -poly * dr_dy / f_denom * f;
  d.df3 = -(poly * dr_dz + g.two_a2 * r * x3) / f_denom * f;

  const T c1 = (x1 - T(2) * r * l1) / denom;
  const T c2 = (x2 - T(2) * r * l2) / denom;
  const T a_denom = (T(1) / denom) * spin;
  d.dl[0][0] = c1 * dr_dx + r / denom;
  d.dl[0][1] = c1 * dr_dy + a_denom;
  d.dl[0][2] = c1 * dr_dz;
  d.dl[1][0] = c2 * dr_dx - a_denom;
  d.dl[1][1] = c2 * dr_dy + r / denom;
  d.dl[1][2] = c2 * dr_dz;
  d.dl[2][0] = -x3 / r2 * dr_dx;
  d.dl[2][1] = -x3 / r2 * dr_dy;
  d.dl[2][2] = -x3 / r2 * dr_dz + T(1) / r;
  d.r = r;
  d.f = f;
  d.l1 = l1;
  d.l2 = l2;
  d.l3 = l3;
}

// Geodesic right-hand side (geometry.py:243-315): dy/dlambda for the seven
// dynamical components (x^0..x^3, p_1..p_3; p_0 is conserved) and, when
// ds is given, the proper-distance rate. geodesic_rhs_flat is the flat
// metric's; geodesic_rhs_at takes the Kerr-Schild derivatives d at the
// point.
template <typename T>
__device__ __forceinline__ void geodesic_rhs_flat(T p0, T p1, T p2, T p3, T out[7], T* ds) {
  out[0] = -p0; out[1] = p1; out[2] = p2; out[3] = p3;
  out[4] = T(0); out[5] = T(0); out[6] = T(0);
  if (ds) *ds = -m_sqrt(p1 * p1 + p2 * p2 + p3 * p3);
}

template <typename T>
__device__ __forceinline__ void geodesic_rhs_at(const KsDerivs<T>& d, T p0, T p1, T p2, T p3,
                                                T out[7], T* ds) {
  const T f = d.f, l1 = d.l1, l2 = d.l2, l3 = d.l3;
  const T df_dx = d.df1, df_dy = d.df2, df_dz = d.df3;
  const T dl1x = d.dl[0][0], dl1y = d.dl[0][1], dl1z = d.dl[0][2];
  const T dl2x = d.dl[1][0], dl2y = d.dl[1][1], dl2z = d.dl[1][2];
  const T dl3x = d.dl[2][0], dl3y = d.dl[2][1], dl3z = d.dl[2][2];

  // geodesic_rhs_c
  const T lp = -p0 + l1 * p1 + l2 * p2 + l3 * p3;
  const T flp = f * lp;
  const T k0 = -p0 + flp;
  const T k1 = p1 - flp * l1;
  const T k2 = p2 - flp * l2;
  const T k3 = p3 - flp * l3;
  const T dlp1 = dl1x * p1 + dl2x * p2 + dl3x * p3;
  const T dlp2 = dl1y * p1 + dl2y * p2 + dl3y * p3;
  const T dlp3 = dl1z * p1 + dl2z * p2 + dl3z * p3;
  const T half_lp2 = T(0.5) * lp * lp;
  out[0] = k0; out[1] = k1; out[2] = k2; out[3] = k3;
  out[4] = df_dx * half_lp2 + flp * dlp1;
  out[5] = df_dy * half_lp2 + flp * dlp2;
  out[6] = df_dz * half_lp2 + flp * dlp3;
  if (ds) {
    const T scale = f * k0 / (T(-1) - f);
    const T q1 = k1 - scale * l1;
    const T q2 = k2 - scale * l2;
    const T q3 = k3 - scale * l3;
    const T lq = l1 * q1 + l2 * q2 + l3 * q3;
    const T ds2 = q1 * q1 + q2 * q2 + q3 * q3 + f * lq * lq;
    // 1e-300 is 0 in float, as the JAX weak-typed literal is in float32
    *ds = -m_sqrt(jmax(ds2, T(1e-300)));
  }
}

template <typename T>
__device__ __forceinline__ void geodesic_rhs(T x1, T x2, T x3, T p0, T p1, T p2,
                                             T p3, const KerrConsts<T>& g,
                                             T out[7], T* ds) {
  if (g.flat) {
    geodesic_rhs_flat(p0, p1, p2, p3, out, ds);
    return;
  }
  KsDerivs<T> d;
  ks_derivatives(x1, x2, x3, g, d);
  geodesic_rhs_at(d, p0, p1, p2, p3, out, ds);
}

// geodesic_rhs that also leaves the Kerr-Schild derivatives at the point
// in d (in the flat metric only d.r), for a caller that carries them.
template <typename T>
__device__ __forceinline__ void geodesic_rhs_keep(T x1, T x2, T x3, T p0, T p1, T p2, T p3,
                                                  const KerrConsts<T>& g, T out[7], T* ds,
                                                  KsDerivs<T>& d) {
  if (g.flat) {
    geodesic_rhs_flat(p0, p1, p2, p3, out, ds);
    d.r = ks_radius(x1, x2, x3, g);
    return;
  }
  ks_derivatives(x1, x2, x3, g, d);
  geodesic_rhs_at(d, p0, p1, p2, p3, out, ds);
}

// geodesic_rhs at a point whose derivatives d were carried in
// (geodesic_rhs_keep).
template <typename T>
__device__ __forceinline__ void geodesic_rhs_from(const KsDerivs<T>& d, T p0, T p1, T p2, T p3,
                                                  const KerrConsts<T>& g, T out[7], T* ds) {
  if (g.flat) {
    geodesic_rhs_flat(p0, p1, p2, p3, out, ds);
    return;
  }
  geodesic_rhs_at(d, p0, p1, p2, p3, out, ds);
}

// Spatial momentum rescale for null renormalization (geometry.py:340-366):
// the root of a x^2 + b x + c, whose coefficients come from the flat metric
// or from f and l at the point. renormalize_factor_fl takes f and l from a
// caller that knows them (it reads none of them in the flat metric);
// renormalize_factor_at forms them at a point whose radius q is known;
// renormalize_factor at a point alone.
template <typename T>
__device__ __forceinline__ T renormalize_factor_fl(T f, T l1, T l2, T l3, T p0, T p1, T p2,
                                                   T p3, const KerrConsts<T>& g) {
  T a, b, c;
  if (g.flat) {
    a = p1 * p1 + p2 * p2 + p3 * p3;
    b = T(0);
    c = -p0 * p0;
  } else {
    const T lsps = l1 * p1 + l2 * p2 + l3 * p3;
    a = p1 * p1 + p2 * p2 + p3 * p3 - f * lsps * lsps;
    b = T(2) * f * lsps * p0;
    c = -(T(1) + f) * p0 * p0;
  }
  const T d = m_sqrt(jmax(b * b - T(4) * a * c, T(1e-300)));
  return (b < T(0)) ? (d - b) / (T(2) * a) : T(-2) * c / (b + d);
}

template <typename T>
__device__ __forceinline__ T renormalize_factor_at(T x1, T x2, T x3, const KsRadius<T>& q,
                                                   T p0, T p1, T p2, T p3,
                                                   const KerrConsts<T>& g) {
  KsScalars<T> s{};
  if (!g.flat) s = ks_scalars(x1, x2, x3, q, g);
  return renormalize_factor_fl(s.f, s.l1, s.l2, s.l3, p0, p1, p2, p3, g);
}

template <typename T>
__device__ __forceinline__ T renormalize_factor(T x1, T x2, T x3, T p0, T p1, T p2, T p3,
                                                const KerrConsts<T>& g) {
  return renormalize_factor_at(x1, x2, x3, ks_radius_parts(x1, x2, x3, g), p0, p1, p2, p3,
                               g);
}

// base + sum_q (w_q h) k_q over the stages with a non-zero weight, summed
// left to right like ops/pallas_formula.py add_stage (:381-394).
template <typename T, int NQ>
__device__ __forceinline__ T dp_combine(T base, const double (&w)[NQ], T h,
                                        const T (&k)[7][7], int c) {
  T acc = T(0);
  bool any = false;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (w[q] != 0.0) {
      const T term = (T(w[q]) * h) * k[q][c];
      acc = any ? acc + term : term;
      any = true;
    }
  }
  return any ? base + acc : base;
}

// One Dormand-Prince attempt of step h from y (x^0..x^3, p_1..p_3) with
// k[0] already evaluated: the six further stages, the 5th-order endpoint
// y5, the embedded 4th-order endpoint y4 and the 4th-order midpoint y4m
// (ops/pallas_formula.py:373-403). With KEEP_LAST, *last receives the
// Kerr-Schild derivatives of the 7th stage (geodesic_rhs_keep): its
// point is y5's position bit for bit (DP_A[6] is DP_B5, summed alike), so
// an accepted step's next first stage can reuse them.
template <typename T, bool KEEP_LAST = false>
__device__ __forceinline__ void dp_stages(const T (&y)[7], T p0, T h,
                                          const KerrConsts<T>& g, T (&k)[7][7],
                                          T (&y5)[7], T (&y4)[7], T (&y4m)[7],
                                          KsDerivs<T>* last = nullptr) {
  constexpr double DP_A[7][6] = {
      {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
      {1.0 / 5.0, 0.0, 0.0, 0.0, 0.0, 0.0},
      {3.0 / 40.0, 9.0 / 40.0, 0.0, 0.0, 0.0, 0.0},
      {44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0, 0.0, 0.0, 0.0},
      {19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0,
       0.0, 0.0},
      {9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
       -5103.0 / 18656.0, 0.0},
      {35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
       11.0 / 84.0}};
  constexpr double DP_B5[7] = {35.0 / 384.0, 0.0, 500.0 / 1113.0,
                               125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0,
                               0.0};
  constexpr double DP_B4[7] = {5179.0 / 57600.0, 0.0, 7571.0 / 16695.0,
                               393.0 / 640.0, -92097.0 / 339200.0,
                               187.0 / 2100.0, 1.0 / 40.0};
  constexpr double DP_B4M[7] = {
      6025192743.0 / 30085553152.0, 0.0, 51252292925.0 / 65400821598.0,
      -2691868925.0 / 45128329728.0, 187940372067.0 / 1594534317056.0,
      -1776094331.0 / 19743644256.0, 11237099.0 / 235043384.0};
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    T ys[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      // weights beyond stage i-1 are zero and skipped
      ys[c] = dp_combine<T, 6>(y[c], DP_A[i], h, k, c);
    }
    if (KEEP_LAST && i == 6) {
      geodesic_rhs_keep(ys[1], ys[2], ys[3], p0, ys[4], ys[5], ys[6], g, k[i],
                        static_cast<T*>(nullptr), *last);
    } else {
      geodesic_rhs(ys[1], ys[2], ys[3], p0, ys[4], ys[5], ys[6], g, k[i],
                   static_cast<T*>(nullptr));
    }
  }
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    y5[c] = dp_combine<T, 7>(y[c], DP_B5, h, k, c);
    y4[c] = dp_combine<T, 7>(y[c], DP_B4, h, k, c);
    y4m[c] = dp_combine<T, 7>(y[c], DP_B4M, h, k, c);
  }
}

}  // namespace bl
