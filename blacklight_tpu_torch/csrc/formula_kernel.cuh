// Fused formula-model ray tracer for NVIDIA Hopper (sm_90a): geodesic step,
// formula coefficients and unpolarized transfer for one ray per thread.
//
// Replaces the TPU kernel blacklight_tpu/ops/pallas_formula.py:_make_kernel
// (:192-596, launched by render_formula :599-697) for one frequency without
// tangents. The dp body follows :363-485, the rk4/rk2 body :487-578, the
// sample and transfer update transfer_update :270-355 and the finalization
// :582-594. Each thread loops over its own step counter n and stops when
// its ray dies, which gives the Pallas block loop's semantics exactly: all
// rays of a block start together there, and a dead ray's outputs never
// change again.
//
// What bounds it on this card: FP32 (or FP64) ALU work and register
// pressure. A ray reads 9 values and writes 3 over thousands of steps, so
// device-memory traffic is negligible. A dp step is seven right-hand sides
// (about 60 operations each, with divisions and square roots), an error
// norm and two null renormalizations; the seven stages are held in
// registers (49 values), and the double instantiations may spill to local
// memory (-Xptxas -v reports it).
//
// Warp divergence: rays of one warp end at different steps, and a warp runs
// until its longest ray ends. Rays come in the caller's order (row-major
// pixels, so a warp covers 32 neighbouring pixels of one image row). Later
// work may order rays by image tile, as bench.py:117-124 does for the JAX
// scan, so that a warp holds rays of similar length, or use persistent
// threads that fetch a new ray when theirs ends.
//
// Every constant is T(...): a bare double literal would promote the float
// instantiation to FP64 arithmetic. Division by a constant is
// multiplication by its reciprocal, rounded once on the host or at compile
// time, as the plain PyTorch version computes it.
//
// The instantiations live in two translation units built with different
// multiply-add contraction (ops/_build.py): formula_kernel.cu holds rk4
// and rk2 without contraction, so that they round as the plain version
// does step by step; formula_kernel_dp.cu holds dp with contraction, whose
// agreement with the plain version is statistical in any case.

#pragma once

#include <cuda_runtime.h>

#include "formula_params.cuh"
#include "kerr.cuh"

namespace bl {

enum Integrator : int { INTEGRATOR_DP = 0, INTEGRATOR_RK4 = 1, INTEGRATOR_RK2 = 2 };

constexpr int THREADS = 128;
constexpr double DELTA_TAU_MAX = 100.0;  // unpolarized.cpp:96-110
constexpr double HALF_PI = 1.5707963267948966;

template <typename T>
__device__ __forceinline__ bool flag_at(const double* p, int i) {
  return T(p[i]) != T(0);
}

// Formula-model constants of one launch (FormulaParams plus frequency).
template <typename T>
struct FormulaConsts {
  T bh_a, a2, two_a, two_m, neg_two_m_a, camera_r, l0, one_plus_q, inv_r0_sq;
  T h_sq, inv_nup, a_param, cn0, ej, ej_sign, ea, ea_sign;
  bool ej_int, ea_int;
  bool cut_near, cut_far, cut_in_on, cut_out_on, cut_plane;
  int mid_theta_sign, mid_z_sign;
  T cut_in, cut_out, mid_theta, mid_z;
  T plane_o[3], plane_n[3];
  T cam[4];
  T nu, x_unit_over_nu;

  __device__ explicit FormulaConsts(const double* p) {
    bh_a = T(p[P_F_BH_A]);
    a2 = T(p[P_F_A2]);
    two_a = T(p[P_F_TWO_A]);
    two_m = T(p[P_F_TWO_M]);
    neg_two_m_a = T(p[P_F_NEG_TWO_M_A]);
    camera_r = T(p[P_F_CAMERA_R]);
    l0 = T(p[P_F_L0]);
    one_plus_q = T(p[P_F_ONE_PLUS_Q]);
    inv_r0_sq = T(p[P_F_INV_R0_SQ]);
    h_sq = T(p[P_F_H_SQ]);
    inv_nup = T(p[P_F_INV_NUP]);
    a_param = T(p[P_F_A_PARAM]);
    cn0 = T(p[P_F_CN0]);
    ej = T(p[P_EJ]);
    ej_int = flag_at<T>(p, P_EJ_IS_INT);
    ej_sign = T(p[P_EJ_SIGN]);
    ea = T(p[P_EA]);
    ea_int = flag_at<T>(p, P_EA_IS_INT);
    ea_sign = T(p[P_EA_SIGN]);
    cut_near = flag_at<T>(p, P_CUT_NEAR);
    cut_far = flag_at<T>(p, P_CUT_FAR);
    cut_in_on = flag_at<T>(p, P_CUT_IN_ON);
    cut_in = T(p[P_CUT_IN]);
    cut_out_on = flag_at<T>(p, P_CUT_OUT_ON);
    cut_out = T(p[P_CUT_OUT]);
    mid_theta_sign = static_cast<int>(p[P_CUT_MID_THETA_SIGN]);
    mid_theta = T(p[P_CUT_MID_THETA]);
    mid_z_sign = static_cast<int>(p[P_CUT_MID_Z_SIGN]);
    mid_z = T(p[P_CUT_MID_Z]);
    cut_plane = flag_at<T>(p, P_CUT_PLANE);
    plane_o[0] = T(p[P_PLANE_OX]);
    plane_o[1] = T(p[P_PLANE_OY]);
    plane_o[2] = T(p[P_PLANE_OZ]);
    plane_n[0] = T(p[P_PLANE_NX]);
    plane_n[1] = T(p[P_PLANE_NY]);
    plane_n[2] = T(p[P_PLANE_NZ]);
    cam[0] = T(p[P_CAM_X0]);
    cam[1] = T(p[P_CAM_X1]);
    cam[2] = T(p[P_CAM_X2]);
    cam[3] = T(p[P_CAM_X3]);
    nu = T(p[P_NU]);
    x_unit_over_nu = T(p[P_X_UNIT_OVER_NU]);
  }
};

// C++ pow with a constant exponent e for a possibly negative base
// (pallas_formula.py:159-175): sign^e |x|^e for integer e, 0 at x == 0.
template <typename T>
__device__ __forceinline__ T cpp_pow(T x, T e, bool is_int, T sign) {
  if (x > T(0)) return m_pow(x, e);
  if (is_int && x < T(0)) return sign * m_pow(-x, e);
  return T(0);
}

// Invariant j (in units of cn0/nup^2) and alpha at one sample, with the
// cut mask applied, and whether the sample is bad (C++ would give NaN):
// _formula_geom_c (:68-144) and _formula_jalpha_c (:147-186).
template <typename T>
__device__ __forceinline__ void formula_coefficients(
    const FormulaConsts<T>& c, T x1, T x2, T x3, T k0, T k1, T k2, T k3, T mom,
    T& j_out, T& alpha_out, bool& bad_out) {
  const T a = c.bh_a;
  const T rr2 = x1 * x1 + x2 * x2 + x3 * x3;
  const T r = m_sqrt(T(0.5) * (rr2 - c.a2 + m_hypot(rr2 - c.a2, c.two_a * x3)));

  bool keep = r <= c.camera_r;
  if (c.cut_near || c.cut_far) {
    const T dot = x1 * c.cam[1] + x2 * c.cam[2] + x3 * c.cam[3];
    if (c.cut_near) keep = keep && !(dot > T(0));
    if (c.cut_far) keep = keep && !(dot < T(0));
  }
  if (c.cut_in_on) keep = keep && !(r < c.cut_in);
  if (c.cut_out_on) keep = keep && !(r > c.cut_out);
  if (c.mid_theta_sign != 0) {
    const T off = m_abs(m_acos(x3 / r) - T(HALF_PI));
    keep = keep && (c.mid_theta_sign > 0 ? !(off > c.mid_theta)
                                         : !(off < c.mid_theta));
  }
  if (c.mid_z_sign != 0) {
    const T az = m_abs(x3);
    keep = keep && (c.mid_z_sign > 0 ? !(az > c.mid_z) : !(az < c.mid_z));
  }
  if (c.cut_plane) {
    keep = keep && !((x1 - c.plane_o[0]) * c.plane_n[0] +
                         (x2 - c.plane_o[1]) * c.plane_n[1] +
                         (x3 - c.plane_o[2]) * c.plane_n[2] <
                     T(0));
  }

  const T rr = m_sqrt(jmax(r * r - x3 * x3, T(1e-30)));
  const T cth = x3 / r;
  const T sth = m_sqrt(jmax(T(1) - cth * cth, T(0)));
  // sin/cos of ph = atan2(x2, x1) - atan(a/r) in closed form
  const T rho_s = m_sqrt(jmax(x1 * x1 + x2 * x2, T(1e-30))) * m_sqrt(r * r + c.a2);
  const T cph = (x1 * r + x2 * a) / rho_s;
  const T sph = (x2 * r - x1 * a) / rho_s;

  const T delta = r * r - c.two_m * r + c.a2;
  const T gtt = -(T(1) + c.two_m * r * (r * r + c.a2) /
                            (delta * (r * r + c.a2 * cth * cth)));
  const T sigma = r * r + c.a2 * cth * cth;
  const T gtph = c.neg_two_m_a * r / (delta * sigma);
  const T gphph = (sigma - c.two_m * r) / (delta * sigma * sth * sth);

  const T ll = (T(1) / (T(1) + rr)) * c.l0 * m_pow(rr, c.one_plus_q);
  const T u_arg = -gtt + T(2) * gtph * ll - gphph * ll * ll;
  bool bad = !(u_arg > T(0));
  const T u_norm = T(1) / m_sqrt(u_arg > T(0) ? u_arg : T(1));
  const T u_t = -u_norm;
  const T u_ph = u_norm * ll;
  const T u0 = gtt * u_t + gtph * u_ph;
  const T uph = gtph * u_t + gphph * u_ph;
  const T u1 = sth * (-r * sph - a * cph) * uph;
  const T u2 = sth * (r * cph - a * sph) * uph;
  const T n_n0 = m_exp(T(-0.5) * (r * r * c.inv_r0_sq + c.h_sq * cth * cth));
  const T u_dot_k = u0 * k0 + u1 * k1 + u2 * k2 + T(0) * k3;

  const T nu_fluid = -u_dot_k * c.nu * mom;
  const T x_raw = nu_fluid * c.inv_nup;
  const T pj = cpp_pow(x_raw, c.ej, c.ej_int, c.ej_sign);
  if (!c.ej_int) bad = bad || (x_raw < T(0));
  // a non-integer alpha exponent of a negative base routes to the j-only
  // branch like alpha = 0
  const T pa = cpp_pow(x_raw, c.ea, c.ea_int, c.ea_sign);
  const T j = n_n0 * pj;
  const T alpha = c.cn0 * (c.a_param * n_n0 * pa * nu_fluid);
  j_out = keep ? j : T(0);
  alpha_out = keep ? alpha : T(0);
  bad_out = bad && keep;
}

// Transfer update at one valid sample (transfer_update, :270-355): the
// invariant source-function recurrence with the optically thick trap.
template <typename T>
__device__ __forceinline__ void transfer_sample(
    const FormulaConsts<T>& c, T x1, T x2, T x3, T k0, T k1, T k2, T k3, T mom,
    T h, T& intensity, T& tau, bool& bad_acc) {
  T j, alpha;
  bool cbad;
  formula_coefficients(c, x1, x2, x3, k0, k1, k2, k3, mom, j, alpha, cbad);
  cbad = cbad || !(m_isfinite(j) && m_isfinite(alpha));
  if (cbad) {
    j = T(0);
    alpha = T(0);
  }
  bad_acc = bad_acc || cbad;

  const T dl_cgs = (-h) * c.x_unit_over_nu / mom;
  const bool pos_alpha = alpha > T(0);
  const T ss = j / (pos_alpha ? alpha : T(1));
  const T delta_tau = alpha * dl_cgs;
  const T atten = m_exp(-tau);
  const bool thin = delta_tau <= T(DELTA_TAU_MAX);
  const T em = -m_expm1(-delta_tau);
  const T contrib = pos_alpha ? (thin ? ss * em : ss) : j * dl_cgs;
  intensity = intensity + contrib * atten;
  tau = tau + (pos_alpha ? (thin ? delta_tau : T(INFINITY)) : T(0));
}

template <typename T, int INTEGRATOR>
__global__ void __launch_bounds__(THREADS)
    formula_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                   const T* __restrict__ momentum_factors,
                   const double* __restrict__ params, T* __restrict__ i_nu,
                   int* __restrict__ flags_out, int* __restrict__ n_samples_out,
                   long long n_rays) {
  const long long ray = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  const double* p = params;

  KerrConsts<T> g;
  g.spin = T(p[P_SPIN]);
  g.a2 = T(p[P_A2]);
  g.two_spin = T(p[P_TWO_SPIN]);
  g.two_a2 = T(p[P_TWO_A2]);
  g.three_a2 = T(p[P_THREE_A2]);
  g.two_mass = T(p[P_TWO_MASS]);
  g.flat = flag_at<T>(p, P_FLAT);
  const T ray_step = T(p[P_RAY_STEP]);
  const T camera_r = T(p[P_CAMERA_R]);
  const T r_terminate = T(p[P_R_TERMINATE]);
  const T r_horizon = T(p[P_R_HORIZON]);
  const T tol_abs = T(p[P_TOL_ABS]);
  const T tol_rel = T(p[P_TOL_REL]);
  const int max_steps = static_cast<int>(p[P_MAX_STEPS]);
  const int max_retries = static_cast<int>(p[P_MAX_RETRIES]);
  const bool fallback_nan = flag_at<T>(p, P_FALLBACK_NAN);
  const T i_scale = T(p[P_I_SCALE]);
  const FormulaConsts<T> fc(p);

  // state: x^0..x^3, p_1..p_3 (p_0 is conserved)
  T y[7];
  y[0] = positions[4 * ray + 0];
  y[1] = positions[4 * ray + 1];
  y[2] = positions[4 * ray + 2];
  y[3] = positions[4 * ray + 3];
  const T p0 = directions[4 * ray + 0];
  y[4] = directions[4 * ray + 1];
  y[5] = directions[4 * ray + 2];
  y[6] = directions[4 * ray + 3];
  const T mom = momentum_factors[ray];

  T h = -ray_step * ks_radius(y[1], y[2], y[3], g);  // dp only
  bool trunc = false, flag = false, bad = false, prev_fail = false;
  T r_mid_prev = T(0), intensity = T(0), tau = T(0);
  int n_samp = 0, num_retry = 0;

  for (int n = 0; n < max_steps; ++n) {
    const T r = ks_radius(y[1], y[2], y[3], g);
    T ye[7], ym[7];  // step endpoint and stored (midpoint) sample
    T hs;            // signed step of this attempt
    bool accept = true, retry_exceeded = false;

    if (INTEGRATOR == INTEGRATOR_DP) {
      T k[7][7], y4[7], ds;
      geodesic_rhs(y[1], y[2], y[3], p0, y[4], y[5], y[6], g, k[0], &ds);
      const T ds_dlam = m_abs(ds) + T(1e-30);
      const T h_cap = ray_step * r / ds_dlam;
      hs = -jmin(m_abs(h), h_cap);
      dp_stages(y, p0, hs, g, k, ye, y4, ym);

      // error estimate over the 7 dynamical components (p_0 error = 0)
      T err = T(0);
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        const T ya = jmax(m_abs(y[c]), m_abs(ye[c]));
        const T sc = tol_abs + tol_rel * ya;
        err = jmax(err, m_abs(ye[c] - y4[c]) / sc);
      }
      accept = err <= T(1);
      const T err_safe = jmax(err, T(1e-30));
      const T fac_ideal = T(DP_ERR_FACTOR) * m_pow(err_safe, T(-DP_ERR_POWER));
      const T fac_rej =
          jmax(m_isfinite(err) ? fac_ideal : T(DP_MIN_FACTOR), T(DP_MIN_FACTOR));
      T fac_acc = jmin(jmax(fac_ideal, T(DP_MIN_FACTOR)), T(DP_MAX_FACTOR));
      if (err == T(0)) fac_acc = T(DP_MAX_FACTOR);
      if (prev_fail) fac_acc = jmin(fac_acc, T(1));
      h = hs * (accept ? fac_acc : fac_rej);
      num_retry = accept ? 0 : num_retry + 1;
      retry_exceeded = num_retry > max_retries;
      flag = flag || retry_exceeded;
      prev_fail = !accept;
    } else {
      // fixed step h = -ray_step (r - r_horizon) (geodesics.cpp:418-795)
      hs = -ray_step * (r - r_horizon);
      T k1[7], k2[7];
      geodesic_rhs(y[1], y[2], y[3], p0, y[4], y[5], y[6], g, k1,
                   static_cast<T*>(nullptr));
      if (INTEGRATOR == INTEGRATOR_RK4) {
        T yt[7], k3[7], k4[7];
#pragma unroll
        for (int c = 0; c < 7; ++c) yt[c] = y[c] + (T(0.5) * hs) * k1[c];
        geodesic_rhs(yt[1], yt[2], yt[3], p0, yt[4], yt[5], yt[6], g, k2,
                     static_cast<T*>(nullptr));
#pragma unroll
        for (int c = 0; c < 7; ++c) yt[c] = y[c] + (T(0.5) * hs) * k2[c];
        geodesic_rhs(yt[1], yt[2], yt[3], p0, yt[4], yt[5], yt[6], g, k3,
                     static_cast<T*>(nullptr));
#pragma unroll
        for (int c = 0; c < 7; ++c) yt[c] = y[c] + hs * k3[c];
        geodesic_rhs(yt[1], yt[2], yt[3], p0, yt[4], yt[5], yt[6], g, k4,
                     static_cast<T*>(nullptr));
#pragma unroll
        for (int c = 0; c < 7; ++c) {
          ye[c] = y[c] + hs * (k1[c] * T(1.0 / 6.0) + k2[c] * T(1.0 / 3.0) +
                               k3[c] * T(1.0 / 3.0) + k4[c] * T(1.0 / 6.0));
          ym[c] = T(0.5) * (y[c] + ye[c]);
        }
      } else {
        // rk2 (Heun); the sample is y + h/2 k1 (geodesics.cpp:626-795)
        T yt[7];
#pragma unroll
        for (int c = 0; c < 7; ++c) yt[c] = y[c] + hs * k1[c];
        geodesic_rhs(yt[1], yt[2], yt[3], p0, yt[4], yt[5], yt[6], g, k2,
                     static_cast<T*>(nullptr));
#pragma unroll
        for (int c = 0; c < 7; ++c) {
          ye[c] = y[c] + T(0.5) * hs * (k1[c] + k2[c]);
          ym[c] = y[c] + (T(0.5) * hs) * k1[c];
        }
      }
    }

    // accepted endpoint and stored sample, null-renormalized
    const T fac = renormalize_factor(ye[1], ye[2], ye[3], p0, ye[4], ye[5], ye[6], g);
    const T r_new = ks_radius(ye[1], ye[2], ye[3], g);
    const T facm = renormalize_factor(ym[1], ym[2], ym[3], p0, ym[4], ym[5], ym[6], g);
    const T r_mid = ks_radius(ym[1], ym[2], ym[3], g);

    const bool trunc_now =
        n_samp > 0 &&
        ((r_mid > camera_r && r_mid > r_mid_prev) || r_mid < r_terminate);
    trunc = trunc || (accept && trunc_now);
    const bool valid = accept && !trunc && !retry_exceeded;
    const bool terminate = (r_new > camera_r && r_new > r) || r_new < r_terminate;
    flag = flag || (accept && !terminate && n == max_steps - 1);
    const bool alive = !(accept && terminate) && !retry_exceeded;

    if (valid) {
      transfer_sample(fc, ym[1], ym[2], ym[3], p0, ym[4] * facm, ym[5] * facm,
                      ym[6] * facm, mom, hs, intensity, tau, bad);
      r_mid_prev = r_mid;
      ++n_samp;
    }
    if (!alive) break;
    if (accept) {
      y[0] = ye[0];
      y[1] = ye[1];
      y[2] = ye[2];
      y[3] = ye[3];
      y[4] = ye[4] * fac;
      y[5] = ye[5] * fac;
      y[6] = ye[6] * fac;
    }
  }

  const bool poison = bad || (fallback_nan && flag);
  i_nu[ray] = poison ? T(NAN) : intensity * i_scale;
  flags_out[ray] = flag ? 1 : 0;
  n_samples_out[ray] = n_samp;
}

// Pointers and sizes of one launch, as the C interface receives them.
struct LaunchArgs {
  const void* positions;
  const void* directions;
  const void* momentum_factors;
  const double* params;
  void* i_nu;
  int* flags;
  int* n_samples;
  long long n_rays;
  cudaStream_t stream;
};

template <typename T, int INTEGRATOR>
cudaError_t launch(const LaunchArgs& a) {
  const unsigned blocks = static_cast<unsigned>((a.n_rays + THREADS - 1) / THREADS);
  formula_kernel<T, INTEGRATOR><<<blocks, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.positions), static_cast<const T*>(a.directions),
      static_cast<const T*>(a.momentum_factors), a.params, static_cast<T*>(a.i_nu),
      a.flags, a.n_samples, a.n_rays);
  return cudaGetLastError();
}

// dp in float (dtype_code 0) or double (1); defined in formula_kernel_dp.cu.
cudaError_t launch_dp(int dtype_code, const LaunchArgs& a);

}  // namespace bl
