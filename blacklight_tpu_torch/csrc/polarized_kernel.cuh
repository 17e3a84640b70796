// Polarized (full-Stokes IQUV) simulation-model ray tracer for NVIDIA
// Hopper (sm_90a) in three stages: geodesic steps, GRMHD grid sampling,
// polarized synchrotron coefficients (thermal, or mixed with power-law
// and kappa electrons) and coherency-tensor transfer with tetrad-frame
// matter coupling.
//
// Replaces the TPU kernel blacklight_tpu/ops/pallas_polarized.py
// _make_kernel (:286, launched by render_polarized :727, call :787; K3.1)
// for a single-block SKS grid, thermal ti_te_beta electrons, dp, rk4 and
// rk2, and float32 and float64. Its values follow the JAX package's exact
// (XLA) path in each type's forms: transfer/polarized.py
// integrate_polarized with pipeline_simulation.make_simulation_coeff_fns
// (polarized=True). The plain PyTorch version is
// blacklight_tpu_torch/ops/polarized_kernel.py render_polarized_reference
// (transfer/polarized.py sample_record and apply_record, ops/connection.py,
// ops/tetrad.py, transfer/polarized_coupling.py, models/synchrotron.py);
// this file writes their operation forms. Like the TPU kernel it returns
// the final coherency components; the caller takes camera-frame Stokes
// (transfer/polarized.camera_stokes) and poisons NaN pixels.
//
// The transfer takes samples far end first while the geodesic runs from
// the camera, and almost all of a sample's work does not depend on the
// coherency tensor N that the transfer carries from sample to sample. So
// the route has three kernels (ops/polarized_kernel.py launches them):
//   polarized_trace_kernel, one thread per ray: integrates the ray once,
//     forward, with trace.cuh's step_ray and stores every valid sample
//     (x, y, z, k1, k2, k3, h) in device memory;
//   polarized_derive_kernel, one thread per stored sample: everything of
//     the sample that does not touch N (the grid sample and fluid state of
//     sim_sample.cuh, the three transport matrices, the step lengths, the
//     fluid tetrad, the coefficients of each frequency times the step, and
//     the bad-sample bits), written as one record per sample;
//   polarized_chain_kernel, one thread per ray: reads its records far end
//     first and applies the deferred second half of the previous sample's
//     transport, this sample's first half, N -> Stokes, the matter coupling
//     and Stokes -> N; at the camera end the nearest sample's second half.
// Samples and records are laid out per warp of 32 rays, slot-major and
// padded to the warp's longest ray ([warp][slot][value][lane]), so every
// stage's loads and stores coalesce.
//
// What bounds it on this card: the operations, ~4,700 a sample at one
// frequency (the step ~830, the sample's ~2,700 and ~1,100 per
// frequency; 52.6 ms for a 1024^2 float32 image of 721 samples a ray at
// 67 TFLOP/s), and their latency. The TPU kernel's shape, one thread per
// ray running all of it in two sweeps (a forward sweep keeping window
// carries, then each window replayed and taken far end first), needs 229
// registers here (8 warps an SM), integrates every step twice, keeps a
// window's samples in local memory and runs each per-window loop as long
// as the warp's longest window. Here the step runs once, the heavy
// per-sample code runs one thread per sample with no per-ray state and
// no ray-length divergence, and only the chain (~900 operations a
// sample) stays sequential per ray. What that costs is bytes: the
// records, 58 values a sample at one frequency, written once and read
// once (~0.12 s of traffic for a 1024^2 image of 721 samples a ray at
// 3.35 TB/s), which bound the derive and chain kernels.
//
// The instantiations live in translation units that nvcc builds side by
// side, none with multiply-add contraction (ops/_build.py), so that each
// operation rounds as the plain version's does: polarized_trace.cu (the
// trace kernel, every type and integrator), polarized_derive.cu and
// polarized_derive_f64.cu (the derive kernel in float and double),
// polarized_derive_blocks.cu (on many mesh blocks) and polarized_chain.cu
// (the chain kernel and the C interface). The derive kernel of the
// thermal, power-law and kappa populations summed
// (polarized_derive_mixture_kernel, POP_MIXTURE: mixture_polarized, with
// the populations' constants after the parameter vector) lives in units
// of its own, polarized_derive_mixture{,_f64,_blocks}.cu, so that the
// thermal units compile as they did; the trace and chain kernels do not
// depend on the population (a record holds the same eight coefficients).
// The derive kernel on an FMKS block (polarized_derive_fmks{,_f64}.cu)
// and on a CKS grid (AthenaK's: polarized_derive_mode_kernel and the
// mixture's in sim_sample.cuh's SAMPLE_CKS_* modes, the sample at its own
// (x, y, z), fluid_state_cks; polarized_derive_cks{,_f64}.cu) live in
// units of their own as well.
#pragma once

#include <cuda_runtime.h>

#include "polarized_params.cuh"
#include "sim_sample.cuh"

namespace bl {

constexpr int POL_THREADS = 128;
constexpr int POL_WARP = 32;
constexpr int POL_MAX_FREQUENCIES = 4;  // per derive/chain launch; more go to more launches
constexpr double POL_DELTA_TAU_MAX = 100.0;  // unpolarized.cpp:96-110
constexpr double THETA_E_ZERO = 0.01;        // radiation_integrator.hpp:190
constexpr double PI = 3.141592653589793;
constexpr double EULER_GAMMA = 0.5772156649015328606;
constexpr int BESSEL_SERIES_TERMS = 22;  // models/synchrotron.py :279-288
constexpr int BESSEL_CF2_ITERS = 40;

// ---- Bessel K (models/synchrotron.py :291-428) ----------------------------
// Constants of the k-th term of the small-argument series, folded in
// float64 as the JAX package folds them in Python.
template <int K>
struct BesselTerm {
  static constexpr double fact = BesselTerm<K - 1>::fact * K;
  static constexpr double h = BesselTerm<K - 1>::h + 1.0 / K;
  static constexpr double inv_sq = 1.0 / (fact * fact);
  static constexpr double inv_11 = 1.0 / (fact * fact * (K + 1.0));
  static constexpr double k1_coef = 2.0 * h + 1.0 / (K + 1.0) - 2.0 * EULER_GAMMA;
};
template <>
struct BesselTerm<0> {
  static constexpr double fact = 1.0;
  static constexpr double h = 0.0;
};

template <typename T, int K>
__device__ __forceinline__ void bessel_series_terms(T t, T& tk, T& i0, T& k0_sum, T& i1_sum,
                                                    T& k1_sum) {
  if constexpr (K <= BESSEL_SERIES_TERMS) {
    using B = BesselTerm<K>;
    tk = tk * t;
    i0 = i0 + tk * T(B::inv_sq);
    k0_sum = k0_sum + tk * T(B::inv_sq) * T(B::h);
    i1_sum = i1_sum + tk * T(B::inv_11);
    k1_sum = k1_sum + tk * T(B::inv_11) * T(B::k1_coef);
    bessel_series_terms<T, K + 1>(t, tk, i0, k0_sum, i1_sum, k1_sum);
  }
}

// K0, K1 by the ascending series (DLMF 10.31.2-3), for x <= 3.
template <typename T>
__device__ __forceinline__ void bessel_k01_small(T x, T& k0, T& k1) {
  const T t = x * x / T(4);
  T tk = T(1), i0 = T(1), k0_sum = T(0), i1_sum = T(1);
  T k1_sum = T(1.0 - 2.0 * EULER_GAMMA);
  bessel_series_terms<T, 1>(t, tk, i0, k0_sum, i1_sum, k1_sum);
  const T lnx2 = m_log(x / T(2));
  const T i1 = T(0.5) * x * i1_sum;
  k0 = -(lnx2 + T(EULER_GAMMA)) * i0 + k0_sum;
  k1 = T(1) / x + lnx2 * i1 - T(0.25) * x * k1_sum;
}

// K0, K1 for x >= 2 by Steed's continued fraction CF2 (Temme's method,
// mu = 0); SCALED gives e^x K. float64 only (its recurrences overflow
// single precision).
template <bool SCALED>
__device__ __forceinline__ void bessel_k01_large(double x, double& k0, double& k1) {
  const double a1 = 0.25;
  double b = 2.0 * (1.0 + x);
  double d = 1.0 / b;
  double h = d, delh = d;
  double q1 = 0.0, q2 = 1.0, q = a1, c = a1;
  double a = -a1;
  double s = 1.0 + q * delh;
#pragma unroll 4
  for (int i = 2; i < BESSEL_CF2_ITERS + 2; ++i) {
    a = a - 2.0 * (i - 1);
    c = -a * c / i;
    const double qnew = (q1 - b * q2) / a;
    q1 = q2;
    q2 = qnew;
    q = q + c * qnew;
    b = b + 2.0;
    d = 1.0 / (b + a * d);
    delh = (b * d - 1.0) * delh;
    h = h + delh;
    s = s + q * delh;
  }
  h = a1 * h;
  double pref = sqrt((1.0 / (2.0 * x)) * PI);  // pi / (2 x) as PyTorch forms it
  if (!SCALED) pref = pref * exp(-x);
  k0 = pref / s;
  k1 = k0 * (x + 0.5 - h) / x;
}

// Coefficients of the large-argument asymptotic series of e^x K_nu
// (4 nu^2 = NU4: 0 for K0, 4 for K1).
template <int K, int NU4>
struct AsymTerm {
  static constexpr double m = (2.0 * K - 1.0) * (2.0 * K - 1.0);
  static constexpr double a = AsymTerm<K - 1, NU4>::a * ((NU4 - m) / (8.0 * K));
};
template <int NU4>
struct AsymTerm<0, NU4> {
  static constexpr double a = 1.0;
};

template <int K>
__device__ __forceinline__ void bessel_asym_terms(float inv, float& xk, float& p0, float& p1) {
  if constexpr (K <= 8) {
    p0 = p0 + float(AsymTerm<K, 0>::a) * xk;
    p1 = p1 + float(AsymTerm<K, 4>::a) * xk;
    xk = xk * inv;
    bessel_asym_terms<K + 1>(inv, xk, p0, p1);
  }
}

// e^x K0, e^x K1 from the asymptotic series (float32 only).
__device__ __forceinline__ void bessel_k01_asymptotic(float x, float& k0, float& k1) {
  const float inv = 1.0f / x;
  float p0 = 1.0f, p1 = 1.0f, xk = inv;
  bessel_asym_terms<1>(inv, xk, p0, p1);
  const float pref = sqrtf((1.0f / (2.0f * x)) * float(PI));
  k0 = pref * p0;
  k1 = pref * p1;
}

// (e^x K0, e^x K1, e^x K2): the series below x = 3, above it the CF2 in
// float64 and the asymptotic series in float32.
template <typename T>
__device__ __forceinline__ void bessel_k012_scaled(T x, T& k0, T& k1, T& k2) {
  if (x <= T(3)) {
    const T xs = jmax(x, T(1e-30));
    T k0s, k1s;
    bessel_k01_small(xs, k0s, k1s);
    const T e = m_exp(xs);
    k0 = k0s * e;
    k1 = k1s * e;
  } else if constexpr (TypeForms<T>::F64) {
    bessel_k01_large<true>(x, k0, k1);
  } else {
    bessel_k01_asymptotic(x, k0, k1);
  }
  k2 = k0 + T(2) * k1 / x;
}

// K0, K1, K2 (float64): the series below x = 3, the CF2 above.
__device__ __forceinline__ void bessel_k012(double x, double& k0, double& k1, double& k2) {
  if (x <= 3.0) {
    bessel_k01_small(jmax(x, 1e-300), k0, k1);
  } else {
    bessel_k01_large<false>(x, k0, k1);
  }
  k2 = k0 + 2.0 * k1 / x;
}

// ---- thermal polarized coefficients ---------------------------------------
// models/synchrotron.py thermal_coefficients(polarized=True) (:785-936).
// What depends on the cell and not on the frequency: the fluid-frame
// angle and the Bessel functions of 1 / theta_e.
template <typename T>
struct PolCell {
  T n_e, theta_e, kb_tt_e, nu_c, nu_s, sin_b, cos_b, sin2_b, u_dot_k;
  T kk0, kk1, kk2;  // float64: K(1/theta); float32: e^x-scaled K's
  T inv_theta, log_k0s;
};

template <typename T>
struct PolCoeffs {
  T j_i, j_q, j_v, a_i, a_q, a_v, rho_q, rho_v;
};

template <typename T>
__device__ __forceinline__ void pol_cell_bessel(PolCell<T>& pc) {
  if constexpr (TypeForms<T>::F64) {
    pc.inv_theta = T(1) / jmax(pc.theta_e, T(THETA_E_ZERO));
    bessel_k012(pc.inv_theta, pc.kk0, pc.kk1, pc.kk2);
    pc.log_k0s = T(0);
  } else {
    pc.inv_theta = jmax(T(1) / jmax(pc.theta_e, T(THETA_E_ZERO)), T(1e-15));
    bessel_k012_scaled(pc.inv_theta, pc.kk0, pc.kk1, pc.kk2);
    pc.log_k0s = m_log(pc.kk0);
  }
}

template <typename T>
__device__ __forceinline__ PolCoeffs<T> thermal_polarized(const SimConsts<T>& c, T e_squared,
                                                          T me_c, const PolCell<T>& pc,
                                                          T nu_cgs) {
  using Forms = TypeForms<T>;
  const ThermalI<T> ti =
      thermal_i(c, nu_cgs, pc.n_e, pc.nu_c, pc.nu_s, pc.sin_b, pc.kb_tt_e);
  const T theta_e = pc.theta_e;
  const T frac = c.thermal_frac;
  PolCoeffs<T> o;
  o.j_i = ti.j;
  o.a_i = ti.alpha;

  // j_Q, j_V (M 29-30): float32 floors theta_e inside the power and the
  // division; float64 divides by it literally
  const T theta_f = Forms::F64 ? theta_e : jmax(theta_e, T(1e-15));
  const T th_096 = m_pow(theta_f, T(0.96));
  const T var_d = (T(7) * th_096 + T(35)) / (T(10) * th_096 + T(75)) * c.var_b;
  const T var_e = ti.xx_1_2 + var_d * ti.xx_1_6;
  const T var_f = pc.cos_b / theta_f;
  const T var_g = T(PI / 3.0) + T(PI / 3.0) * ti.xx_1_3 + T(2.0 / 300.0) * ti.xx_1_2 +
                  T(2.0 / 19.0 * PI) * (ti.xx_1_3 * ti.xx_1_3);
  o.j_q = -ti.coefficient * ti.var_a * var_e * var_e;
  o.j_v = ti.coefficient * var_f * var_g;
  o.a_q = ti.trap ? T(0) : o.j_q * ti.kirch;
  o.a_v = ti.trap ? T(0) : o.j_v * ti.kirch;

  // Faraday rotativities (M 33-37)
  const T xx = ti.xx;
  const T nu_2 = nu_cgs * nu_cgs;
  const T coefficient_q =
      -frac * pc.n_e * e_squared * (pc.nu_c * pc.nu_c) * pc.sin2_b / (me_c * nu_2);
  const T coefficient_v =
      T(2) * frac * pc.n_e * e_squared * pc.nu_c * pc.cos_b / (me_c * nu_cgs);
  const T xx_neg_1_2 = T(1) / m_sqrt(xx);
  const T var_a2 = T(2.011) * m_exp(T(-19.78) * m_pow(xx, T(-0.5175)));
  const T var_b2 = m_cos(T(39.89) * xx_neg_1_2) * m_exp(T(-70.16) * m_pow(xx, T(-0.6)));
  const T var_c2 = T(0.011) * m_exp(T(-1.69) * xx_neg_1_2);
  const T var_d2 = T(0.003135) * m_pow(xx, T(4.0 / 3.0));
  const T var_e2 = T(0.5) * (T(1) + m_tanh(T(10) * m_log(T(0.6648) * xx_neg_1_2)));
  const T f_0 = var_a2 - var_b2 - var_c2;
  const T f_m = f_0 + (var_c2 - var_d2) * var_e2;
  T factor_q, factor_v;
  if constexpr (Forms::F64) {
    // the reference's literal (K0 - delta) / K2 with its < 0 / > 1 trap
    const T delta_jj_5 = T(0.4379) * m_log(T(1) + T(1.3414) * m_pow(xx, T(-0.7515)));
    factor_q = f_m * (pc.kk1 / pc.kk2 + T(6) * theta_e);
    factor_v = (pc.kk0 - delta_jj_5) / pc.kk2;
    if (factor_v < T(0) || factor_v > T(1)) factor_v = T(1);
  } else {
    // e^x-scaled K's and the trap taken in log space
    const T delta_jj_5 = T(0.4379) * m_log1p(T(1.3414) * m_pow(xx, T(-0.7515)));
    factor_q = f_m * (pc.kk1 / pc.kk2 + T(6) * theta_e);
    const T log_de = m_log(jmax(delta_jj_5, T(1e-30))) + pc.inv_theta;
    const bool ok_v = log_de <= pc.log_k0s;
    const T de = m_exp(jmin(log_de, pc.log_k0s));
    factor_v = ok_v ? (pc.kk0 - de) / pc.kk2 : T(1);
  }
  const bool cold = theta_e < T(THETA_E_ZERO);
  o.rho_q = coefficient_q * (cold ? T(0) : factor_q);
  o.rho_v = coefficient_v * (cold ? T(1) : factor_v);
  return o;
}

// ---- the power-law and kappa populations, polarized ------------------------
// models/synchrotron.py powerlaw_coefficients (:556-641) and
// kappa_coefficients (:665-748) with polarized=True, and their sum with the
// thermal coefficients (all_coefficients :751-782). float64 keeps the
// reference's literal forms (inf and NaN at exactly degenerate cells flag
// the sample), float32 the hardened ones (floors, sin clamped into
// [1e-6, 1 - 1e-7] in its fractional powers, 0 * inf cancelled).
template <typename T>
__device__ __forceinline__ PolCoeffs<T> powerlaw_polarized(const MixConsts<T>& m,
                                                           const PolCell<T>& pc, T r2,
                                                           T nu_cgs) {
  using Forms = TypeForms<T>;
  const T n_e = pc.n_e, nu_c = pc.nu_c, sin_b = pc.sin_b, cos_b = pc.cos_b;
  const T ncs = jmax(nu_c * sin_b, Forms::pop_floor());
  const T sin_c = Forms::F64 ? sin_b : jmin(jmax(sin_b, T(1e-6)), T(1.0 - 1e-7));
  const T ratio = nu_cgs / ncs;
  const T frac = m[M_PL_FRAC];
  PolCoeffs<T> o;
  const T var_a = pow_s(ratio, m[M_PL_J_EXP]);
  const T coeff_j = frac * n_e * nu_c * r2 * m[M_PL_JJ] * sin_b * var_a;
  o.j_i = coeff_j;
  o.j_q = coeff_j * m[M_PL_JJ_Q];
  if constexpr (Forms::F64) {
    const T var_b = cos_b / sin_b;
    const T var_c = T(1) / m_sqrt(nu_cgs / (T(3) * nu_c * sin_b));
    o.j_v = coeff_j * m[M_PL_JJ_V] * var_b * var_c;
  } else {
    // (cos / sin) sqrt(3 nu_c sin / nu) with sin cancelled
    const T arg = T(3) * ncs / nu_cgs;
    const T root = arg > T(1e-30) ? m_sqrt(arg) : T(0);
    const T coeff_j_nosin = frac * n_e * nu_c * r2 * m[M_PL_JJ] * var_a;
    o.j_v = coeff_j_nosin * m[M_PL_JJ_V] * cos_b * root;
  }
  const T coeff_a = frac * n_e * m[M_KA] * m[M_PL_AA] * pow_s(ratio, m[M_PL_A_EXP]);
  o.a_i = coeff_a;
  const T var_b2 = pow_s(pow_s(sin_c, T(-1.92)) * T(3.1) - T(3.1), T(0.512));
  const T var_c2 = T(1) / m_sqrt(ratio);
  o.a_q = coeff_a * m[M_PL_AA_Q];
  o.a_v = coeff_a * m[M_PL_AA_V] * var_b2 * var_c2 * cos_sign(cos_b);
  const T e3_arg = T(2) * nu_c * m[M_PL_GMIN2] * sin_b / (T(3) * nu_cgs);
  if constexpr (Forms::F64) {
    // rotativities (M 40-42), literal forms
    const T var_a3 = n_e * m[M_KA] * nu_cgs / (nu_c * sin_b);
    const T var_b3 = nu_c * sin_b / nu_cgs;
    const T var_c3 = var_b3 * var_b3;
    const T var_d3 = var_c3 * var_b3;
    const T var_e3 = T(1) - pow_s(e3_arg, m[M_PL_E3_EXP]);
    const T var_f3 = cos_b / sin_b;
    const T coeff_r = m[M_PL_FRAC_RHO] * var_a3;
    o.rho_q = coeff_r * m[M_PL_RHO_Q] * var_d3 * var_e3;
    o.rho_v = coeff_r * m[M_PL_RHO_V] * var_c3 * var_f3;
  } else {
    // the 1 / (nu_c sin) of var_a3 cancelled into var_d3 and var_c3
    const T var_e3 = T(1) - pow_s(jmax(e3_arg, T(1e-20)), m[M_PL_E3_EXP]);
    const T coeff_r = m[M_PL_FRAC_RHO] * n_e * m[M_KA];
    const T q = ncs / nu_cgs;
    o.rho_q = coeff_r * m[M_PL_RHO_Q] * (q * q) * var_e3;
    o.rho_v = coeff_r * m[M_PL_RHO_V] * nu_c * cos_b / nu_cgs;
  }
  return o;
}

// One bracket's rho_Q and rho_V terms of the kappa rotativities.
template <typename T>
__device__ __forceinline__ T kappa_rho_q_term(T var_a3, T xx, T a, T b, T c, T d, T e) {
  return var_a3 * a *
         (T(1) - m_exp(pow_s(xx, T(0.84)) * b) - m_sin(xx * c) * m_exp(pow_s(xx, e) * d));
}

template <typename T>
__device__ __forceinline__ T kappa_rho_v_term(T rho_v, T var_b3, T var_c3, T a, T bb) {
  return var_b3 * rho_v * a * (T(1) - m_log1p(var_c3 * bb) * T(0.17));
}

template <typename T>
__device__ __forceinline__ PolCoeffs<T> kappa_polarized(const MixConsts<T>& m,
                                                        const PolCell<T>& pc, T r2,
                                                        T nu_cgs) {
  using Forms = TypeForms<T>;
  const T n_e = pc.n_e, nu_c = pc.nu_c, sin_b = pc.sin_b, cos_b = pc.cos_b;
  const KappaTerms<T> k = kappa_terms(m, r2, nu_cgs, n_e, nu_c, sin_b);
  const T xx = k.xx;
  const T sin_cl = Forms::F64 ? sin_b : jmin(jmax(sin_b, T(1e-6)), T(1.0 - 1e-7));
  const T sign = cos_sign(cos_b);
  PolCoeffs<T> o;
  o.j_i = bridge(k.c_low, k.c_high, m[M_KP_X_JI], m[M_KP_NX_JI]);
  const T var_d = pow_s(pow_s(sin_cl, T(-2.4)) - T(1), T(0.48));
  const T var_e = pow_s(xx, T(-0.35));
  const T var_f = pow_s(pow_s(sin_cl, T(-2.5)) - T(1), T(0.44));
  const T var_g = T(1) / m_sqrt(xx);
  o.j_q = -bridge(k.c_low * m[M_KP_JJ_LOW_Q], k.c_high * m[M_KP_JJ_HIGH_Q], m[M_KP_X_JQ],
                  m[M_KP_NX_JQ]);
  o.j_v = bridge(k.c_low * m[M_KP_JJ_LOW_V] * var_d * var_e,
                 k.c_high * m[M_KP_JJ_HIGH_V] * var_f * var_g, m[M_KP_X_JV], m[M_KP_NX_JV]) *
          sign;
  o.a_i = bridge(k.a_low, k.a_high * m[M_KP_AA_HIGH_I], m[M_KP_X_AI], m[M_KP_NX_AI]);
  const T var_d2 = pow_s(pow_s(sin_cl, T(-2.28)) - T(1), T(0.446));
  const T var_e2 = pow_s(xx, T(-0.35));
  const T var_f2 = m_sqrt(pow_s(sin_cl, T(-2.05)) - T(1));
  const T var_g2 = T(1) / m_sqrt(xx);
  o.a_q = -bridge(k.a_low * m[M_KP_AA_LOW_Q], k.a_high * m[M_KP_AA_HIGH_Q], m[M_KP_X_AQ],
                  m[M_KP_NX_AQ]);
  o.a_v = bridge(k.a_low * m[M_KP_AA_LOW_V] * var_d2 * var_e2,
                 k.a_high * m[M_KP_AA_HIGH_V] * var_f2 * var_g2, m[M_KP_X_AV], m[M_KP_NX_AV]) *
          sign;

  // rotativities (M 51-54), blended between the kappa brackets
  const T var_a3 =
      m[M_KP_NEG_FRAC] * n_e * m[M_KA] * (nu_c * nu_c) * pc.sin2_b / (nu_cgs * nu_cgs);
  const T var_b3 = m[M_KP_TWO_FRAC] * n_e * m[M_KA] * nu_c * cos_b / nu_cgs;
  const T var_c3 = T(1) / m_sqrt(xx);
  o.rho_q = m[M_KP_RHO_1M_FRAC] * kappa_rho_q_term(var_a3, xx, m[M_KP_QL_A], m[M_KP_QL_B],
                                                   m[M_KP_QL_C], m[M_KP_QL_D], m[M_KP_QL_E]) +
            m[M_KP_RHO_FRAC] * kappa_rho_q_term(var_a3, xx, m[M_KP_QH_A], m[M_KP_QH_B],
                                                m[M_KP_QH_C], m[M_KP_QH_D], m[M_KP_QH_E]);
  o.rho_v = m[M_KP_RHO_1M_FRAC] *
                kappa_rho_v_term(m[M_KP_RHO_V], var_b3, var_c3, m[M_KP_VL_A], m[M_KP_VL_B]) +
            m[M_KP_RHO_FRAC] *
                kappa_rho_v_term(m[M_KP_RHO_V], var_b3, var_c3, m[M_KP_VH_A], m[M_KP_VH_B]);
  return o;
}

template <typename T>
__device__ __forceinline__ void add_coeffs(PolCoeffs<T>& o, const PolCoeffs<T>& p, bool have) {
  if (!have) {
    o = p;
    return;
  }
  o.j_i = o.j_i + p.j_i;
  o.j_q = o.j_q + p.j_q;
  o.j_v = o.j_v + p.j_v;
  o.a_i = o.a_i + p.a_i;
  o.a_q = o.a_q + p.a_q;
  o.a_v = o.a_v + p.a_v;
  o.rho_q = o.rho_q + p.rho_q;
  o.rho_v = o.rho_v + p.rho_v;
}

// The eight coefficients of the mixture at one fluid-frame frequency: the
// thermal ones where the thermal fraction is not 0, then the power-law
// and the kappa ones where theirs are not, summed in that order.
template <typename T>
__device__ __forceinline__ PolCoeffs<T> mixture_polarized(const MixConsts<T>& m,
                                                          const SimConsts<T>& c, T e_squared,
                                                          T me_c, const PolCell<T>& pc,
                                                          T nu_cgs) {
  PolCoeffs<T> o = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  bool have = false;
  if (m.on(M_THERMAL_ON)) {
    o = thermal_polarized(c, e_squared, me_c, pc, nu_cgs);
    have = true;
  }
  const T r2 = nu0_ratio_sq(c, nu_cgs);
  if (m.on(M_POWER_ON)) {
    add_coeffs(o, powerlaw_polarized(m, pc, r2, nu_cgs), have);
    have = true;
  }
  if (m.on(M_KAPPA_ON)) add_coeffs(o, kappa_polarized(m, pc, r2, nu_cgs), have);
  return o;
}

// ---- geometry of the transport (ops/connection.py, transfer/polarized.py)

// g^{mn} k_n through the rank-1 Kerr-Schild structure (_kcon_scalar).
template <typename T>
__device__ __forceinline__ void kcon_of(bool flat, const KsDerivs<T>& d, const T (&kcov)[4],
                                        T (&kcon)[4]) {
  if (flat) {
    kcon[0] = -kcov[0];
    kcon[1] = kcov[1];
    kcon[2] = kcov[2];
    kcon[3] = kcov[3];
    return;
  }
  const T lp = -kcov[0] + d.l1 * kcov[1] + d.l2 * kcov[2] + d.l3 * kcov[3];
  const T flp = d.f * lp;
  kcon[0] = -kcov[0] + flp;
  kcon[1] = kcov[1] - flp * d.l1;
  kcon[2] = kcov[2] - flp * d.l2;
  kcon[3] = kcov[3] - flp * d.l3;
}

// A^m_b = k^a Gamma^m_{ab} for the contravariant k (connection.py
// transport_matrix_c); zero in flat spacetime.
template <typename T>
__device__ __forceinline__ void transport_matrix(bool flat, const KsDerivs<T>& d,
                                                 const T (&k)[4], T (&a)[4][4]) {
  if (flat) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int b = 0; b < 4; ++b) a[m][b] = T(0);
    return;
  }
  const T f = d.f;
  const T l[4] = {T(1), d.l1, d.l2, d.l3};
  const T lk = k[0] + d.l1 * k[1] + d.l2 * k[2] + d.l3 * k[3];
  const T kdf = k[1] * d.df1 + k[2] * d.df2 + k[3] * d.df3;
  T kdl[4], s[4];
  const T df[4] = {T(0), d.df1, d.df2, d.df3};
  kdl[0] = T(0);
  s[0] = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    kdl[i + 1] = k[1] * d.dl[i][0] + k[2] * d.dl[i][1] + k[3] * d.dl[i][2];
    s[i + 1] = d.dl[0][i] * k[1] + d.dl[1][i] * k[2] + d.dl[2][i] * k[3];
  }
  // p(b, e) = d_b l_e, zero in the t slot of either index
  auto p = [&](int b, int e) -> T { return (b == 0 || e == 0) ? T(0) : d.dl[e - 1][b - 1]; };
  T t[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      t[e][b] = kdf * l[e] * l[b] + f * (kdl[e] * l[b] + l[e] * kdl[b]) + df[b] * l[e] * lk +
                f * lk * p(b, e) + f * l[e] * s[b] - df[e] * lk * l[b] - f * s[e] * l[b] -
                f * lk * p(e, b);
    }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const T u = -t[0][b] + d.l1 * t[1][b] + d.l2 * t[2][b] + d.l3 * t[3][b];
    a[0][b] = T(0.5) * (-t[0][b] + f * u);
    a[1][b] = T(0.5) * (t[1][b] - f * d.l1 * u);
    a[2][b] = T(0.5) * (t[2][b] - f * d.l2 * u);
    a[3][b] = T(0.5) * (t[3][b] - f * d.l3 * u);
  }
}

// The coherency tensor N^{mn} of one frequency: 10 real-symmetric
// components in (00, 01, 02, 03, 11, 12, 13, 22, 23, 33) order and 6
// imaginary-antisymmetric ones in (01, 02, 03, 12, 13, 23) order
// (transfer/polarized.py _SYM, _ANT).
template <typename T>
struct Coherency {
  T re[10];
  T im[6];
};

__device__ __forceinline__ constexpr int sym_index(int m, int n) {
  return m > n ? sym_index(n, m)
               : (m == 0 ? n : (m == 1 ? 3 + n : (m == 2 ? 5 + n : 9)));
}
__device__ __forceinline__ constexpr int ant_index(int m, int n) {
  return m == 0 ? n - 1 : (m == 1 ? 1 + n : 5);  // m < n
}
__device__ __forceinline__ constexpr int sym_m(int i) {
  return i < 4 ? 0 : (i < 7 ? 1 : (i < 9 ? 2 : 3));
}
__device__ __forceinline__ constexpr int sym_n(int i) {
  return i < 4 ? i : (i < 7 ? i - 3 : (i < 9 ? i - 5 : 3));
}
__device__ __forceinline__ constexpr int ant_m(int i) { return i < 3 ? 0 : (i < 5 ? 1 : 2); }
__device__ __forceinline__ constexpr int ant_n(int i) {
  return i < 3 ? i + 1 : (i < 5 ? i - 1 : 3);
}

// Half-step parallel transport (polarized.cpp:174-192; _transport_c):
// out = base - dl (A^m_b N^{bn} + A^n_b N^{mb}), N = src.
template <typename T>
__device__ __forceinline__ void transport(const T (&a)[4][4], const Coherency<T>& src,
                                          const Coherency<T>& base, T dl, Coherency<T>& out) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int m = sym_m(i), n = sym_n(i);
    T d = T(0);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const T t = a[m][b] * src.re[sym_index(b, n)] + a[n][b] * src.re[sym_index(m, b)];
      d = b == 0 ? t : d + t;
    }
    out.re[i] = base.re[i] - dl * d;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int m = ant_m(i), n = ant_n(i);
    T d = T(0);
    bool any = false;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b != n) {  // Im N^{bn}, antisymmetry folded in
        const T v = b < n ? src.im[ant_index(b, n)] : -src.im[ant_index(n, b)];
        const T t = a[m][b] * v;
        d = any ? d + t : t;
        any = true;
      }
      if (m != b) {  // Im N^{mb}
        const T v = m < b ? src.im[ant_index(m, b)] : -src.im[ant_index(b, m)];
        const T t = a[n][b] * v;
        d = any ? d + t : t;
        any = true;
      }
    }
    out.im[i] = base.im[i] - dl * d;
  }
}

// Tetrad-frame (I, Q, U, V) from N (polarized.cpp:264-292; _stokes_from_n);
// e1, e2 are the covariant tetrad rows.
template <typename T>
__device__ __forceinline__ void stokes_from_n(const T (&e1)[4], const T (&e2)[4],
                                              const Coherency<T>& nn, T (&s)[4]) {
  T nt00 = T(0), nt11 = T(0), nt01 = T(0);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const T r = nn.re[sym_index(m, m)];
    const T t00 = e1[m] * e1[m] * r;
    const T t11 = e2[m] * e2[m] * r;
    const T t01 = e1[m] * e2[m] * r;
    nt00 = m == 0 ? t00 : nt00 + t00;
    nt11 = m == 0 ? t11 : nt11 + t11;
    nt01 = m == 0 ? t01 : nt01 + t01;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int m = ant_m(i), n = ant_n(i);
    const T r = nn.re[sym_index(m, n)];
    nt00 = nt00 + T(2) * e1[m] * e1[n] * r;
    nt11 = nt11 + T(2) * e2[m] * e2[n] * r;
    nt01 = nt01 + (e1[m] * e2[n] + e1[n] * e2[m]) * r;
  }
  T s_v = T(0);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int m = ant_m(i), n = ant_n(i);
    const T t = (e2[m] * e1[n] - e2[n] * e1[m]) * nn.im[i];
    s_v = i == 0 ? t : s_v + t;
  }
  s[0] = T(0.5) * (nt00 + nt11);
  s[1] = T(0.5) * (nt00 - nt11);
  s[2] = nt01;
  s[3] = s_v;
}

// N from tetrad-frame Stokes (polarized.cpp:793-813; _n_from_stokes); t1,
// t2 are the contravariant tetrad rows.
template <typename T>
__device__ __forceinline__ void n_from_stokes(const T (&t1)[4], const T (&t2)[4],
                                              const T (&s)[4], Coherency<T>& nn) {
  const T ipq = s[0] + s[1];
  const T imq = s[0] - s[1];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int m = sym_m(i), n = sym_n(i);
    nn.re[i] = t1[m] * t1[n] * ipq + (t1[m] * t2[n] + t2[m] * t1[n]) * s[2] +
               t2[m] * t2[n] * imq;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int m = ant_m(i), n = ant_n(i);
    nn.im[i] = s[3] * (t2[m] * t1[n] - t1[m] * t2[n]);
  }
}

// Rows e_1 and e_2 of the orthonormal fluid tetrad, contravariant (t1, t2)
// and covariant (e1, e2) (ops/tetrad.py tetrad_rows_c; f = 0 and l = 0 in
// flat spacetime).
template <typename T>
__device__ __forceinline__ void tetrad_rows(const T (&ucon)[4], const T (&kcon)[4],
                                            const T (&kcov)[4], const T (&up)[4], T f, T l1,
                                            T l2, T l3, T (&t1)[4], T (&t2)[4], T (&e1)[4],
                                            T (&e2)[4]) {
  auto ldot = [&](const T(&v)[4]) -> T { return v[0] + l1 * v[1] + l2 * v[2] + l3 * v[3]; };
  auto dot4 = [](const T(&a)[4], const T(&b)[4]) -> T {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
  };
  auto cov = [&](const T(&v)[4], T(&w)[4]) {
    const T lv = f * ldot(v);
    w[0] = -v[0] + lv;
    w[1] = v[1] + l1 * lv;
    w[2] = v[2] + l2 * lv;
    w[3] = v[3] + l3 * lv;
  };
  const T omega = -dot4(kcov, ucon);
  const T k_up = dot4(kcov, up) / omega;
  T ucov[4];
  cov(ucon, ucov);
  const T u_up = dot4(ucov, up) / omega;
  T e3[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) e3[m] = kcon[m] / omega - ucon[m];
#pragma unroll
  for (int m = 0; m < 4; ++m) t2[m] = up[m] - k_up * e3[m] + u_up * kcon[m];
  const T le2 = ldot(t2);
  const T inner = -t2[0] * t2[0] + t2[1] * t2[1] + t2[2] * t2[2] + t2[3] * t2[3] + f * le2 * le2;
  const T norm = m_sqrt(inner);
#pragma unroll
  for (int m = 0; m < 4; ++m) t2[m] = t2[m] / norm;
  auto lc = [&](int a, int b, int c) -> T {
    return ucon[a] * (t2[b] * e3[c] - t2[c] * e3[b]);
  };
  e1[0] = lc(1, 3, 2) + lc(2, 1, 3) + lc(3, 2, 1);
  e1[1] = lc(0, 2, 3) + lc(2, 3, 0) + lc(3, 0, 2);
  e1[2] = lc(0, 3, 1) + lc(1, 0, 3) + lc(3, 1, 0);
  e1[3] = lc(0, 1, 2) + lc(1, 2, 0) + lc(2, 0, 1);
  // con(e1)
  const T lw = f * (-e1[0] + l1 * e1[1] + l2 * e1[2] + l3 * e1[3]);
  t1[0] = -e1[0] + lw;
  t1[1] = e1[1] - l1 * lw;
  t1[2] = e1[2] - l2 * lw;
  t1[3] = e1[3] - l3 * lw;
  cov(t2, e2);
}

// ---- matter coupling (transfer/polarized_coupling.py :235-539) -----------

template <typename T>
__device__ __forceinline__ T safe_recip(T den) {
  return T(1) / (m_abs(den) > TypeForms<T>::coupling_recip_guard() ? den : T(1));
}

// I >= 0 and sqrt(Q^2 + U^2 + V^2) <= I.
template <typename T>
__device__ __forceinline__ void admissibility_clamp(T (&s)[4]) {
  const T s0c = jmax(s[0], T(0));
  const T pol = s[1] * s[1] + s[2] * s[2] + s[3] * s[3];
  const T factor =
      pol > s0c * s0c ? s0c / m_sqrt(jmax(pol, TypeForms<T>::coupling_sqrt_floor())) : T(1);
  s[0] = s0c;
  s[1] = s[1] * factor;
  s[2] = s[2] * factor;
  s[3] = s[3] * factor;
}

// Faraday rotation alone (I A2-A5).
template <typename T>
__device__ __forceinline__ void rotate(T (&s)[4], T rho1, T rho3, T rho_p, T rho_sq, T dl) {
  const T cos_rho = m_cos(rho_p * dl);
  const T sin_rho = m_sin(rho_p * dl);
  const T sh = m_sin(rho_p * dl / T(2));
  const T sin_sq_rho = sh * sh;
  const T inv_rho = safe_recip(rho_p);
  const T inv_rho_sq = safe_recip(rho_sq);
  const T rho_ss = rho1 * s[1] + rho3 * s[3];
  const T r1 = s[1] * cos_rho + T(2) * rho1 * rho_ss * inv_rho_sq * sin_sq_rho -
               rho3 * s[2] * inv_rho * sin_rho;
  const T r2 = s[2] * cos_rho + (rho3 * s[1] - rho1 * s[3]) * inv_rho * sin_rho;
  const T r3 = s[3] * cos_rho + T(2) * rho3 * rho_ss * inv_rho_sq * sin_sq_rho +
               rho1 * s[2] * inv_rho * sin_rho;
  s[1] = r1;
  s[2] = r2;
  s[3] = r3;
}

// Emission with isotropic absorption (alpha_Q = alpha_V = 0).
template <typename T>
__device__ __forceinline__ void couple_simple(T (&s)[4], T j0, T j1, T j3, T a_i, T dl,
                                              bool thin) {
  const T tau = a_i * dl;
  const T inv_ai = safe_recip(a_i);
  if (!thin) {
    s[0] = j0 * inv_ai;
    s[1] = j1 * inv_ai;
    s[2] = T(0);
    s[3] = j3 * inv_ai;
    return;
  }
  const T exp_neg = m_exp(-tau);
  const T tau_c = jmin(tau, TypeForms<T>::coupling_exp_max());
  const T em1_over_tau = tau_c < T(1e-4)
                             ? T(1) + tau_c * (T(0.5) + tau_c * (T(1.0 / 6.0) + tau_c / T(24)))
                             : m_expm1(tau_c) / tau_c;
  const T edl = em1_over_tau * dl;
  s[0] = exp_neg * (s[0] + j0 * edl);
  s[1] = exp_neg * (s[1] + j1 * edl);
  s[2] = exp_neg * s[2];
  s[3] = exp_neg * (s[3] + j3 * edl);
}

// Emission with polarized absorption and no rotation (I A14-A17).
template <typename T>
__device__ __forceinline__ void couple_absorption(T (&s)[4], T j0, T j1, T j3, T a1, T a3,
                                                  T a_i, T alpha_p, T alpha_sq, T dl,
                                                  bool thin) {
  const T tau = a_i * dl;
  const T inv_ai = safe_recip(a_i);
  const T fac = safe_recip(a_i * a_i - alpha_sq);
  const T alpha_j = a1 * j1 + a3 * j3;
  const T t0_thick = (a_i * j0 - alpha_j) * fac;
  if (!thin) {
    s[0] = t0_thick;
    s[1] = (j1 - a1 * t0_thick) * inv_ai;
    s[2] = T(0);
    s[3] = (j3 - a3 * t0_thick) * inv_ai;
    return;
  }
  const T exp_neg_i = m_exp(-tau);
  const T ap_dl = jmin(alpha_p * dl, TypeForms<T>::coupling_exp_max());
  const T exp_neg_p = m_exp(-ap_dl);
  const T sinh_p = m_sinh(ap_dl);
  const T cosh_p = m_cosh(ap_dl);
  const T coshm1_p = T(0.5) * (m_expm1(ap_dl) + exp_neg_p - T(1));
  const T alpha_ss = a1 * s[1] + a3 * s[3];
  const T inv_ap = safe_recip(alpha_p);
  const T inv_asq = safe_recip(alpha_sq);
  const T omexp_over = tau < T(1e-4)
                           ? T(1) - tau * (T(0.5) - tau * (T(1.0 / 6.0) - tau / T(24)))
                           : (T(1) - exp_neg_i) / tau;
  const T omexp_dl = omexp_over * dl;
  const T s0 = s[0];
  const T t0_thin = (s0 * cosh_p - alpha_ss * inv_ap * sinh_p) * exp_neg_i +
                    alpha_j * fac * (T(-1) + (a_i * sinh_p + alpha_p * cosh_p) * inv_ap * exp_neg_p) +
                    a_i * j0 * fac * (T(1) - (a_i * cosh_p + alpha_p * sinh_p) * inv_ai * exp_neg_p);
  auto rest = [&](T aa, T jj, T ss) -> T {
    const T term_1 = (ss + aa * alpha_ss * inv_asq * coshm1_p - s0 * aa * inv_ap * sinh_p) *
                     exp_neg_i;
    const T term_2 = jj * omexp_dl;
    const T term_3 =
        alpha_j * aa * inv_ai * fac *
        (T(1) - (T(1) - a_i * a_i * inv_asq - a_i * inv_asq * (a_i * cosh_p + alpha_p * sinh_p)) *
                    exp_neg_i);
    const T term_4 =
        j0 * aa * inv_ap * fac * (-alpha_p + (alpha_p * cosh_p + a_i * sinh_p) * exp_neg_i);
    return term_1 + term_2 + term_3 + term_4;
  };
  const T r1 = rest(a1, j1, s[1]);
  const T r3 = rest(a3, j3, s[3]);
  s[0] = t0_thin;
  s[1] = r1;
  s[2] = s[2] * exp_neg_i;
  s[3] = r3;
}

// (p (I + M4) + q (I - M4) + r M2 + s M3) . v with the M2/M3 sparsity
// folded into g01, g03, g12 and pm = p - q (_gmatvec).
template <typename T>
struct CouplingMatrix {
  T m4_00, m4_11, m4_22, m4_33, m4_02, m4_13;
  T m2_01, m2_03, m2_12, m3_01, m3_03, m3_12;

  __device__ __forceinline__ void apply(T p, T q, T r, T sc, T v0, T v1, T v2, T v3,
                                        T (&o)[4]) const {
    const T pm = p - q;
    const T g01 = r * m2_01 + sc * m3_01;
    const T g03 = r * m2_03 + sc * m3_03;
    const T g12 = r * m2_12 + sc * m3_12;
    const T pq = p + q;
    o[0] = (pq + pm * m4_00) * v0 + g01 * v1 + pm * m4_02 * v2 + g03 * v3;
    o[1] = g01 * v0 + (pq + pm * m4_11) * v1 + g12 * v2 + pm * m4_13 * v3;
    o[2] = -pm * m4_02 * v0 - g12 * v1 + (pq + pm * m4_22) * v2;
    o[3] = g03 * v0 + pm * m4_13 * v1 + (pq + pm * m4_33) * v3;
  }
};

// Polarized absorption and rotation together (L 10, I 24).
template <typename T>
__device__ __forceinline__ void couple_matrix(T (&s)[4], T j0, T j1, T j3, T a1, T a3, T a_i,
                                              T alpha_sq, T rho1, T rho3, T rho_sq, T dl,
                                              bool thin) {
  const T floor = TypeForms<T>::coupling_sqrt_floor();
  const T alpha_rho = a1 * rho1 + a3 * rho3;
  const T asr = alpha_sq - rho_sq;
  const T lambda_a = m_sqrt(jmax(asr * asr / T(4) + alpha_rho * alpha_rho, floor));
  const T lambda_b = asr / T(2);
  const T lam1 = m_sqrt(jmax(lambda_a + lambda_b, floor));
  const T lam2 = m_sqrt(jmax(lambda_a - lambda_b, floor));
  const T ctheta = lam1 * lam1 + lam2 * lam2;
  const T inv_ct = safe_recip(ctheta);
  const T sgn = alpha_rho >= T(0) ? T(1) : T(-1);

  CouplingMatrix<T> mm;
  mm.m2_01 = (lam2 * a1 - sgn * lam1 * rho1) * inv_ct;
  mm.m2_03 = (lam2 * a3 - sgn * lam1 * rho3) * inv_ct;
  mm.m2_12 = (sgn * lam1 * a1 + lam2 * rho1) * inv_ct;
  mm.m3_01 = (lam1 * a1 + sgn * lam2 * rho1) * inv_ct;
  mm.m3_03 = (lam1 * a3 + sgn * lam2 * rho3) * inv_ct;
  mm.m3_12 = -(sgn * lam2 * a1 - lam1 * rho1) * inv_ct;
  const T half_sum = (alpha_sq + rho_sq) / T(2);
  mm.m4_00 = half_sum * T(2) * inv_ct;
  mm.m4_11 = (a1 * a1 + rho1 * rho1 - half_sum) * T(2) * inv_ct;
  mm.m4_22 = -half_sum * T(2) * inv_ct;
  mm.m4_33 = (a3 * a3 + rho3 * rho3 - half_sum) * T(2) * inv_ct;
  mm.m4_02 = (a1 * rho3 - a3 * rho1) * T(2) * inv_ct;
  mm.m4_13 = (a3 * a1 + rho3 * rho1) * T(2) * inv_ct;

  const T f_1 = safe_recip(a_i * a_i - lam1 * lam1);
  const T f_2 = safe_recip(a_i * a_i + lam2 * lam2);
  T pv[4];
  mm.apply(T(0.5) * a_i * f_1, T(0.5) * a_i * f_2, -lam2 * f_2, -lam1 * f_1, j0, j1, T(0), j3,
           pv);
  if (!thin) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = pv[i];
    return;
  }
  const T tau = a_i * dl;
  const T exp_t = m_exp(-tau);
  const T lam1_dl = jmin(lam1 * dl, TypeForms<T>::coupling_exp_max());
  const T sin_t = m_sin(lam2 * dl);
  const T cos_t = m_cos(lam2 * dl);
  const T sinh_t = m_sinh(lam1_dl);
  const T cosh_t = m_cosh(lam1_dl);
  T ov[4], cv[4];
  mm.apply(T(0.5) * cosh_t, T(0.5) * cos_t, -sin_t, -sinh_t, s[0], s[1], s[2], s[3], ov);
  mm.apply(f_1 * T(0.5) * (a_i * cosh_t + lam1 * sinh_t),
           f_2 * T(0.5) * (a_i * cos_t - lam2 * sin_t), f_2 * (-lam2 * cos_t - a_i * sin_t),
           f_1 * (-lam1 * cosh_t - a_i * sinh_t), j0, j1, T(0), j3, cv);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = pv[i] - exp_t * cv[i] + exp_t * ov[i];
}

// One matter-coupling step on tetrad-frame Stokes s
// (couple_matter_scaled_c), clamped admissible. The coefficients come
// rescaled to per-step optical-depth units (times the step, the derive
// kernel's record), under which the algebra is invariant (dl -> 1). Only
// the sample's own regime is evaluated: the XLA form evaluates all and
// selects, which gives the same value.
template <typename T>
__device__ __forceinline__ void couple_matter(T (&s)[4], T j0, T j1, T j3, T a_i, T a1, T a3,
                                              T rho1, T rho3, bool rotation_split) {
  const T dl = T(1);
  const T alpha_sq = a1 * a1 + a3 * a3;
  const T rho_sq = rho1 * rho1 + rho3 * rho3;
  const bool a0_zero = a_i == T(0);
  const bool ap_zero = alpha_sq == T(0);
  const bool rp_zero = rho_sq == T(0);
  const T floor = TypeForms<T>::coupling_sqrt_floor();
  const T alpha_p = m_sqrt(jmax(alpha_sq, floor));
  const T rho_p = m_sqrt(jmax(rho_sq, floor));
  const bool thin = a_i * dl <= T(POL_DELTA_TAU_MAX);

  if (rotation_split) {
    auto half_couple = [&](T(&ss)[4]) {
      const T half = dl / T(2);
      if (a0_zero) {
        ss[0] = ss[0] + j0 * half;
        ss[1] = ss[1] + j1 * half;
        ss[3] = ss[3] + j3 * half;
      } else if (ap_zero) {
        couple_simple(ss, j0, j1, j3, a_i, half, thin);
      } else {
        couple_absorption(ss, j0, j1, j3, a1, a3, a_i, alpha_p, alpha_sq, half, thin);
      }
      admissibility_clamp(ss);
    };
    half_couple(s);
    if (!rp_zero) rotate(s, rho1, rho3, rho_p, rho_sq, dl);
    admissibility_clamp(s);
    half_couple(s);
    admissibility_clamp(s);
    return;
  }
  if (a0_zero && rp_zero) {
    s[0] = s[0] + j0 * dl;
    s[1] = s[1] + j1 * dl;
    s[3] = s[3] + j3 * dl;
  } else if (ap_zero && rp_zero) {
    couple_simple(s, j0, j1, j3, a_i, dl, thin);
  } else if (a0_zero) {
    rotate(s, rho1, rho3, rho_p, rho_sq, dl);
    s[0] = s[0] + j0 * dl;
    s[1] = s[1] + j1 * dl;
    s[3] = s[3] + j3 * dl;
  } else if (rp_zero) {
    couple_absorption(s, j0, j1, j3, a1, a3, a_i, alpha_p, alpha_sq, dl, thin);
  } else {
    couple_matrix(s, j0, j1, j3, a1, a3, a_i, alpha_sq, rho1, rho3, rho_sq, dl, thin);
  }
  admissibility_clamp(s);
}


// ---- the three stages -----------------------------------------------------

// Constants of one launch beyond the simulation kernel's.
template <typename T>
struct PolConsts {
  bool rotation_split;
  T fallback_rho, fallback_pgas, e_squared, me_c;

  __device__ explicit PolConsts(const double* p) {
    rotation_split = flag_at<T>(p, P_ROTATION_SPLIT);
    fallback_rho = T(p[P_FALLBACK_RHO]);
    fallback_pgas = T(p[P_FALLBACK_PGAS]);
    e_squared = T(p[P_E_SQUARED]);
    me_c = T(p[P_ME_C]);
  }
};

// A stored sample: x, y, z, k1, k2, k3 (the covariant spatial momentum; k_0
// = p0) and the signed step h.
constexpr int POL_SAMPLE_VALUES = 7;
// A sample's record (transfer/polarized.py sample_record): its transport
// matrix A(x, k) (the next-nearer sample's deferred second half uses it),
// the averaged matrix of its first half, the two half-step lengths and the
// fluid tetrad rows; then per frequency of the launch the coefficients
// times the step in cm (couple_matter's arguments).
enum RecordValue : int {
  R_A_CUR = 0,     // 16, row-major
  R_A_HALF = 16,   // 16
  R_DL_SEC = 32,   // 0.25 (dl_prev + dl), dl = -h
  R_DL_LOCAL = 33, // 0.5 (dl_prev + dl), dl_prev = 0 at the far end
  R_E1 = 34,       // covariant tetrad rows e1, e2
  R_E2 = 38,
  R_T1 = 42,       // contravariant rows t1, t2
  R_T2 = 46,
  POL_GEOMETRY_VALUES = 50
};
constexpr int POL_COEFFICIENT_VALUES = 8;  // j0, j1, j3, a_i, a1, a3, rho1, rho3

// Sample s of lane `lane` of warp w lies at values
// ((w * cap + s) * POL_SAMPLE_VALUES + q) * POL_WARP + lane, q = 0..6: cap
// slots per warp (the step budget), each a [value][lane] tile.
__device__ __forceinline__ long long sample_at(long long w, int cap, int s, int lane) {
  return ((w * cap + s) * POL_SAMPLE_VALUES) * POL_WARP + lane;
}

// Record slot `slot` of a launch (offsets[w] + s for sample s of warp w)
// with `values` values: value q of lane `lane` at
// (slot * values + q) * POL_WARP + lane.
__device__ __forceinline__ long long record_at(long long slot, int values, int lane) {
  return slot * values * POL_WARP + lane;
}

// Stage 1: one thread per ray integrates it from the camera with step_ray
// and stores its valid samples in step order.
template <typename T, int INTEGRATOR>
__global__ void __launch_bounds__(POL_THREADS)
    polarized_trace_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                           const double* __restrict__ params, T* __restrict__ samples, int cap,
                           int* __restrict__ flags_out, int* __restrict__ n_samples_out,
                           long long n_rays) {
  const long long ray = static_cast<long long>(blockIdx.x) * POL_THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  const TraceConsts<T> tc(params);
  T* __restrict__ out = samples + sample_at(ray / POL_WARP, cap, 0, ray % POL_WARP);
  RayState<T> s;
  init_ray_state(tc, positions + 4 * ray, directions + 4 * ray, s);
  long long k = 0;
  auto on_sample = [&](const T(&ym)[7], T k1, T k2, T k3, T hs, const KsRadius<T>&) {
    T* __restrict__ o = out + k * (POL_SAMPLE_VALUES * POL_WARP);
    o[0 * POL_WARP] = ym[1];
    o[1 * POL_WARP] = ym[2];
    o[2 * POL_WARP] = ym[3];
    o[3 * POL_WARP] = k1;
    o[4 * POL_WARP] = k2;
    o[5 * POL_WARP] = k3;
    o[6 * POL_WARP] = hs;
    ++k;
  };
  bool flag;
  int n_samp;
  trace_ray<T, INTEGRATOR>(tc, s, directions[4 * ray], on_sample, flag, n_samp);
  flags_out[ray] = flag ? 1 : 0;
  n_samples_out[ray] = n_samp;
}

// What the derive and chain kernels read of a launch's stored samples.
template <typename T>
struct SampleSet {
  const T* __restrict__ samples;
  int cap;
  const int* __restrict__ n_samples;  // per ray
  const long long* __restrict__ offsets;  // n_warps + 1: first record slot of each warp
  int n_warps;
  long long n_rays;
};

// Blocks of POL_THREADS the derive kernel asks each SM to hold: in float
// its 220 registers then fit 128 with no spill, 16 warps an SM instead of
// 8 (0.79x the route's time on an H100, PERF.md); double keeps its 254.
template <typename T>
struct DeriveBlocks {
  static constexpr int value = TypeForms<T>::F64 ? 1 : 4;
};

// Stage 2: one thread per stored sample, which a hardware warp's 32 lanes
// take at one slot of one warp of rays. GEOMETRY: the whole record (the
// first frequency group); otherwise only the coefficients of this
// launch's frequencies. Bit f of bad[ray] is set where frequency f met a
// sample the reference would NaN (its coefficients are zeroed). The grid
// is sampled in MODE (sim_sample.cuh SAMPLE_*); g is the thread's index.
// The set and the grid by value, as the kernels' parameters are taken.
// POP_MIXTURE: kappa is the electron entropy's cell table of a code_kappa
// launch (null otherwise).
template <typename T, bool GEOMETRY, int MODE, int POP = POP_THERMAL>
__device__ __forceinline__ void derive_sample(long long g, SampleSet<T> set, long long n_slots,
                                              const T* __restrict__ directions,
                                              const T* __restrict__ momentum_factors,
                                              const T* __restrict__ freqs, int nf,
                                              const double* __restrict__ params,
                                              SampleGrid<T, MODE> grid,
                                              T* __restrict__ geometry,
                                              T* __restrict__ coefficients,
                                              int* __restrict__ bad,
                                              const float* __restrict__ kappa = nullptr) {
  using Forms = TypeForms<T>;
  const long long slot = g / POL_WARP;
  const int lane = static_cast<int>(g % POL_WARP);
  if (slot >= n_slots) return;
  // the warp of rays holding this slot: offsets[w] <= slot < offsets[w + 1]
  int lo = 0, hi = set.n_warps;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(set.offsets + mid) <= slot) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int t = static_cast<int>(slot - __ldg(set.offsets + lo));
  const long long ray = static_cast<long long>(lo) * POL_WARP + lane;
  if (ray >= set.n_rays) return;
  const int n = __ldg(set.n_samples + ray);
  if (t >= n) return;

  const TraceConsts<T> tc(params);
  const SimConsts<T> c(params);
  const PolConsts<T> pk(params);
  const bool flat = tc.g.flat;
  const T* __restrict__ smp = set.samples + sample_at(lo, set.cap, t, lane);
  const T x = __ldg(smp), y = __ldg(smp + POL_WARP), z = __ldg(smp + 2 * POL_WARP);
  const T k1 = __ldg(smp + 3 * POL_WARP), k2 = __ldg(smp + 4 * POL_WARP);
  const T k3 = __ldg(smp + 5 * POL_WARP), h = __ldg(smp + 6 * POL_WARP);
  const T p0 = __ldg(directions + 4 * ray);
  const T mom = __ldg(momentum_factors + ray);
  const T dl_cur = -h;
  const T kcov[4] = {p0, k1, k2, k3};

  KsDerivs<T> d;
  T kcon[4];
  if constexpr (GEOMETRY) {
    if (!flat) ks_derivatives(x, y, z, tc.g, d);
    kcon_of(flat, d, kcov, kcon);
    T* __restrict__ rec = geometry + record_at(slot, POL_GEOMETRY_VALUES, lane);
    // transport matrices; the averaged first-half matrix expands by
    // bilinearity: 0.5 A(prev, k_old) + 0.25 A(cur, k_prev) + 0.25 A(cur, k),
    // prev the next-farther sample (t + 1)
    T a_cur[4][4];
    transport_matrix(flat, d, kcon, a_cur);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int b = 0; b < 4; ++b) rec[(R_A_CUR + 4 * m + b) * POL_WARP] = a_cur[m][b];
    const bool first = t == n - 1;
    T dl_pv = T(0);
    if (first) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int b = 0; b < 4; ++b) rec[(R_A_HALF + 4 * m + b) * POL_WARP] = a_cur[m][b];
    } else {
      const T* __restrict__ pv = smp + POL_SAMPLE_VALUES * POL_WARP;
      const T xp = __ldg(pv), yp = __ldg(pv + POL_WARP), zp = __ldg(pv + 2 * POL_WARP);
      const T kcov_pv[4] = {p0, __ldg(pv + 3 * POL_WARP), __ldg(pv + 4 * POL_WARP),
                            __ldg(pv + 5 * POL_WARP)};
      dl_pv = -__ldg(pv + 6 * POL_WARP);
      KsDerivs<T> dpv;
      if (!flat) ks_derivatives(xp, yp, zp, tc.g, dpv);
      T kcon_pv[4], kcon_old[4], a_kprev[4][4], a_pv[4][4];
      kcon_of(flat, dpv, kcov_pv, kcon_pv);
#pragma unroll
      for (int m = 0; m < 4; ++m) kcon_old[m] = T(0.5) * (kcon_pv[m] + kcon[m]);
      transport_matrix(flat, d, kcon_pv, a_kprev);
      transport_matrix(flat, dpv, kcon_old, a_pv);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          rec[(R_A_HALF + 4 * m + b) * POL_WARP] =
              T(0.5) * a_pv[m][b] + T(0.25) * a_kprev[m][b] + T(0.25) * a_cur[m][b];
    }
    rec[R_DL_SEC * POL_WARP] = T(0.25) * (dl_pv + dl_cur);
    rec[R_DL_LOCAL * POL_WARP] = T(0.5) * ((first ? T(0) : dl_pv) + dl_cur);
  }

  // the grid sample: zeros where a geometric cut holds (the reference's
  // sampler leaves zeros there, which the tetrad consumes), the fallback
  // values off the grid
  const SksPoint<T> pt = sample_point<MODE>(c, x, y, z);
  const bool keep_geo =
      geometric_keep(c.cuts, pt.x, pt.y, pt.z, pt.r, c.camera_r, c.cam1, c.cam2, c.cam3);
  T v[SampleValues<POP>];
  bool off_grid, sampled;
  if constexpr (MODE == SAMPLE_SINGLE) {
    off_grid = is_off_grid(grid, pt);
    sampled = keep_geo && !off_grid;
    if (sampled) {
      int hint[3] = {-1, -1, -1};  // one sample a thread: no previous cell
      sample_cell(grid, pt, v, hint, kappa);
    }
  } else if constexpr (MODE == SAMPLE_FMKS) {
    // the map only where the sample is not cut
    int hint[3] = {-1, -1, -1};
    sampled = keep_geo && sample_fmks(grid, pt, v, hint, kappa);
    off_grid = keep_geo && !sampled;
  } else if constexpr (IsCks<MODE>) {
    // the block search in (x, y, z) only where the sample is not cut
    int hint[3] = {-1, -1, -1}, block = -1;
    sampled = keep_geo && sample_cks<MODE>(grid, pt, v, hint, block, kappa);
    off_grid = keep_geo && !sampled;
  } else {
    // the block search only where the sample is not cut
    int hint[3] = {-1, -1, -1}, block = -1;
    sampled = keep_geo && sample_blocks<MODE>(grid, pt, v, hint, block, kappa);
    off_grid = keep_geo && !sampled;
  }
  if (!sampled) {
#pragma unroll
    for (int q = 0; q < SampleValues<POP>; ++q) v[q] = T(0);
    if (keep_geo) {
      v[0] = pk.fallback_rho;
      v[1] = pk.fallback_pgas;
      if constexpr (POP == POP_MIXTURE) v[8] = T(params[P_COUNT + M_FALLBACK_KAPPA]);
    }
  }
  FluidState<T> st;
  T ucon[4], bcon[4];
  if constexpr (IsCks<MODE>) {
    fluid_state_cks(c, pt, v, st, ucon, bcon);
  } else {
    fluid_state(c, pt, v, st);
  }
  if constexpr (POP == POP_MIXTURE) {
    code_kappa_state(MixConsts<T>(params + P_COUNT), v[0], v[8], st);
  }
  const bool b_zero = v[5] == T(0) && v[6] == T(0) && v[7] == T(0);
  const bool keep = keep_geo && !b_zero && value_keep(c, st);
  const bool bad0 = off_grid && c.fallback_nan && keep_geo;
  if constexpr (!IsCks<MODE>) fluid_cks(pt, c.spin, st, ucon, bcon);

  if constexpr (GEOMETRY) {
    // the fluid tetrad; a field-free cell takes up = (0, 0, 0, 1)
    T* __restrict__ rec = geometry + record_at(slot, POL_GEOMETRY_VALUES, lane);
    const T up[4] = {b_zero ? T(0) : bcon[0], b_zero ? T(0) : bcon[1],
                     b_zero ? T(0) : bcon[2], b_zero ? T(1) : bcon[3]};
    T t1[4], t2[4], e1[4], e2[4];
    if (flat) {
      tetrad_rows(ucon, kcon, kcov, up, T(0), T(0), T(0), T(0), t1, t2, e1, e2);
    } else {
      tetrad_rows(ucon, kcon, kcov, up, d.f, d.l1, d.l2, d.l3, t1, t2, e1, e2);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      rec[(R_E1 + m) * POL_WARP] = e1[m];
      rec[(R_E2 + m) * POL_WARP] = e2[m];
      rec[(R_T1 + m) * POL_WARP] = t1[m];
      rec[(R_T2 + m) * POL_WARP] = t2[m];
    }
  }

  PolCell<T> cell;
  if (keep) {
    const Pitch<T> pa = pitch_angle(p0, k1, k2, k3, ucon, bcon, st.b_sq);
    cell.n_e = st.n_e_cgs;
    cell.theta_e = st.theta_e;
    cell.kb_tt_e = st.kb_tt_e;
    cell.sin_b = safe_sqrt(pa.sin2);
    cell.cos_b = safe_sqrt(pa.cos2) * (pa.b_dot_k >= T(0) ? T(1) : T(-1));
    cell.sin2_b = pa.sin2;
    cell.u_dot_k = pa.u_dot_k;
    cell.nu_c = c.e_charge * st.bb_cgs / c.nu_c_div;
    cell.nu_s = jmax(c.two_ninths * cell.nu_c * (st.theta_e * st.theta_e) * cell.sin_b,
                     Forms::nu_s_floor());
    pol_cell_bessel(cell);
  }
  T* __restrict__ co =
      coefficients + record_at(slot, POL_COEFFICIENT_VALUES * nf, lane);
  const T dl_lam = dl_cur * c.x_unit;
  unsigned bits = 0u;
#pragma unroll 1
  for (int f = 0; f < nf; ++f) {
    const T nu = __ldg(freqs + f);
    PolCoeffs<T> k = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    bool cbad = bad0;
    if (keep) {
      const T nu_cgs = -cell.u_dot_k * nu * mom;
      if constexpr (POP == POP_MIXTURE) {
        k = mixture_polarized(MixConsts<T>(params + P_COUNT), c, pk.e_squared, pk.me_c, cell,
                              nu_cgs);
      } else {
        k = thermal_polarized(c, pk.e_squared, pk.me_c, cell, nu_cgs);
      }
      cbad = cbad || !(m_isfinite(k.j_i) && m_isfinite(k.j_q) && m_isfinite(k.j_v) &&
                       m_isfinite(k.a_i) && m_isfinite(k.a_q) && m_isfinite(k.a_v) &&
                       m_isfinite(k.rho_q) && m_isfinite(k.rho_v));
    }
    if (cbad) {
      bits |= 1u << f;
      k = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    }
    // per-step optical-depth units (couple_matter)
    const T dl_cgs = dl_lam / (nu * mom);
    T* __restrict__ o = co + f * POL_COEFFICIENT_VALUES * POL_WARP;
    o[0 * POL_WARP] = k.j_i * dl_cgs;
    o[1 * POL_WARP] = k.j_q * dl_cgs;
    o[2 * POL_WARP] = k.j_v * dl_cgs;
    o[3 * POL_WARP] = k.a_i * dl_cgs;
    o[4 * POL_WARP] = k.a_q * dl_cgs;
    o[5 * POL_WARP] = k.a_v * dl_cgs;
    o[6 * POL_WARP] = k.rho_q * dl_cgs;
    o[7 * POL_WARP] = k.rho_v * dl_cgs;
  }
  if (bits) atomicOr(bad + ray, static_cast<int>(bits));
}

// The derive kernel on one mesh block, trilinear (SAMPLE_SINGLE).
template <typename T, bool GEOMETRY>
__global__ void __launch_bounds__(POL_THREADS, DeriveBlocks<T>::value)
    polarized_derive_kernel(SampleSet<T> set, long long n_slots,
                            const T* __restrict__ directions,
                            const T* __restrict__ momentum_factors, const T* __restrict__ freqs,
                            int nf, const double* __restrict__ params, GridView<T> grid,
                            T* __restrict__ geometry, T* __restrict__ coefficients,
                            int* __restrict__ bad) {
  derive_sample<T, GEOMETRY, SAMPLE_SINGLE>(
      static_cast<long long>(blockIdx.x) * POL_THREADS + threadIdx.x, set, n_slots, directions,
      momentum_factors, freqs, nf, params, grid, geometry, coefficients, bad);
}

// The derive kernel on many mesh blocks or at the nearest cell (MODE
// SAMPLE_BLOCKS or SAMPLE_INTERBLOCK), instantiated in
// polarized_derive_blocks.cu; on a CKS grid (SAMPLE_CKS_BLOCKS or
// SAMPLE_CKS_INTERBLOCK) in polarized_derive_cks{,_f64}.cu.
template <typename T, bool GEOMETRY, int MODE>
__global__ void __launch_bounds__(POL_THREADS, DeriveBlocks<T>::value)
    polarized_derive_mode_kernel(SampleSet<T> set, long long n_slots,
                                 const T* __restrict__ directions,
                                 const T* __restrict__ momentum_factors,
                                 const T* __restrict__ freqs, int nf,
                                 const double* __restrict__ params, BlockGridView<T> grid,
                                 T* __restrict__ geometry, T* __restrict__ coefficients,
                                 int* __restrict__ bad) {
  derive_sample<T, GEOMETRY, MODE>(
      static_cast<long long>(blockIdx.x) * POL_THREADS + threadIdx.x, set, n_slots, directions,
      momentum_factors, freqs, nf, params, grid, geometry, coefficients, bad);
}

// The derive kernel on one FMKS block (SAMPLE_FMKS), instantiated in
// polarized_derive_fmks.cu and polarized_derive_fmks_f64.cu.
template <typename T, bool GEOMETRY>
__global__ void __launch_bounds__(POL_THREADS, DeriveBlocks<T>::value)
    polarized_derive_fmks_kernel(SampleSet<T> set, long long n_slots,
                                 const T* __restrict__ directions,
                                 const T* __restrict__ momentum_factors,
                                 const T* __restrict__ freqs, int nf,
                                 const double* __restrict__ params, FmksGridView<T> grid,
                                 T* __restrict__ geometry, T* __restrict__ coefficients,
                                 int* __restrict__ bad) {
  derive_sample<T, GEOMETRY, SAMPLE_FMKS>(
      static_cast<long long>(blockIdx.x) * POL_THREADS + threadIdx.x, set, n_slots, directions,
      momentum_factors, freqs, nf, params, grid, geometry, coefficients, bad);
}

// The derive kernel of the mixture population (POP_MIXTURE) on one block or
// many, in any mode, instantiated in polarized_derive_mixture*.cu (and
// SAMPLE_FMKS in polarized_derive_fmks*.cu, the CKS modes in
// polarized_derive_cks*.cu); params holds the MixtureParam values after
// P_COUNT, with the code_kappa temperature's, which reads the electron
// entropy from `kappa` (n_b, n_k, n_j, n_i) float32.
template <typename T, bool GEOMETRY, int MODE>
__global__ void __launch_bounds__(POL_THREADS, DeriveBlocks<T>::value)
    polarized_derive_mixture_kernel(SampleSet<T> set, long long n_slots,
                                    const T* __restrict__ directions,
                                    const T* __restrict__ momentum_factors,
                                    const T* __restrict__ freqs, int nf,
                                    const double* __restrict__ params,
                                    SampleGrid<T, MODE> grid, const float* __restrict__ kappa,
                                    T* __restrict__ geometry, T* __restrict__ coefficients,
                                    int* __restrict__ bad) {
  derive_sample<T, GEOMETRY, MODE, POP_MIXTURE>(
      static_cast<long long>(blockIdx.x) * POL_THREADS + threadIdx.x, set, n_slots, directions,
      momentum_factors, freqs, nf, params, grid, geometry, coefficients, bad, kappa);
}

// The coherency tensor of each frequency of the launch: registers for one,
// a local array for more.
template <typename T, int NF>
__device__ __forceinline__ void zero_coherency(Coherency<T> (&nn)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int i = 0; i < 10; ++i) nn[f].re[i] = T(0);
#pragma unroll
    for (int i = 0; i < 6; ++i) nn[f].im[i] = T(0);
  }
}

// Stage 3: one thread per ray, a hardware warp per warp of rays, warps
// taken longest first (order). The warp walks its slots from the far end;
// a lane joins at its own farthest sample, so that every load of a record
// value is one coalesced row. N and the previous record's A(x, k) stay in
// registers.
template <typename T, int NF>
__global__ void __launch_bounds__(POL_THREADS)
    polarized_chain_kernel(SampleSet<T> set, const int* __restrict__ order,
                           const T* __restrict__ geometry, const T* __restrict__ coefficients,
                           int nf, const double* __restrict__ params, T* __restrict__ nn_out) {
  const int j = blockIdx.x * (POL_THREADS / POL_WARP) + threadIdx.x / POL_WARP;
  if (j >= set.n_warps) return;
  const int lane = threadIdx.x % POL_WARP;
  const int w = __ldg(order + j);
  const long long ray = static_cast<long long>(w) * POL_WARP + lane;
  const bool live = ray < set.n_rays;
  const int n = live ? __ldg(set.n_samples + ray) : 0;
  const long long first_slot = __ldg(set.offsets + w);
  const int len = static_cast<int>(__ldg(set.offsets + w + 1) - first_slot);
  const bool rotation_split = flag_at<T>(params, P_ROTATION_SPLIT);
  const int n_freq = NF == 1 ? 1 : nf;

  Coherency<T> nn[NF];
  zero_coherency(nn);
  T a_prev[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int b = 0; b < 4; ++b) a_prev[m][b] = T(0);

  for (int t = len - 1; t >= 0; --t) {
    if (t >= n) continue;
    const T* __restrict__ rec =
        geometry + record_at(first_slot + t, POL_GEOMETRY_VALUES, lane);
    T a_half[4][4], e1[4], e2[4], t1[4], t2[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int b = 0; b < 4; ++b) a_half[m][b] = __ldcs(rec + (R_A_HALF + 4 * m + b) * POL_WARP);
      e1[m] = __ldcs(rec + (R_E1 + m) * POL_WARP);
      e2[m] = __ldcs(rec + (R_E2 + m) * POL_WARP);
      t1[m] = __ldcs(rec + (R_T1 + m) * POL_WARP);
      t2[m] = __ldcs(rec + (R_T2 + m) * POL_WARP);
    }
    const T dl_sec = __ldcs(rec + R_DL_SEC * POL_WARP);
    const T dl_local = __ldcs(rec + R_DL_LOCAL * POL_WARP);
    const T* __restrict__ co = coefficients +
                               record_at(first_slot + t, POL_COEFFICIENT_VALUES * nf, lane);
#pragma unroll 1
    for (int f = 0; f < n_freq; ++f) {
      const T* __restrict__ o = co + f * POL_COEFFICIENT_VALUES * POL_WARP;
      // the previous sample's deferred second half (its step is this
      // sample's), then this sample's first half (polarized.cpp:815-833)
      Coherency<T> sec, half;
      transport(a_prev, nn[f], nn[f], dl_sec, sec);
      transport(a_half, sec, nn[f], dl_local, half);
      T s[4];
      stokes_from_n(e1, e2, half, s);
      couple_matter(s, __ldcs(o), __ldcs(o + POL_WARP), __ldcs(o + 2 * POL_WARP),
                    __ldcs(o + 3 * POL_WARP), __ldcs(o + 4 * POL_WARP), __ldcs(o + 5 * POL_WARP),
                    __ldcs(o + 6 * POL_WARP), __ldcs(o + 7 * POL_WARP), rotation_split);
      n_from_stokes(t1, t2, s, nn[f]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int b = 0; b < 4; ++b) a_prev[m][b] = __ldcs(rec + (R_A_CUR + 4 * m + b) * POL_WARP);
  }
  if (!live) return;

  // the camera end: the nearest sample's second half, with its own step
  const T dl_pv =
      n > 0 ? -__ldg(set.samples + sample_at(w, set.cap, 0, lane) + 6 * POL_WARP) : T(0);
  T* __restrict__ out = nn_out + 16 * nf * ray;
#pragma unroll 1
  for (int f = 0; f < n_freq; ++f) {
    Coherency<T> fin;
    transport(a_prev, nn[f], nn[f], T(0.5) * dl_pv, fin);
#pragma unroll
    for (int i = 0; i < 10; ++i) out[16 * f + i] = fin.re[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) out[16 * f + 10 + i] = fin.im[i];
  }
}

// Pointers and sizes of the launches, as the C interface receives them.
struct PolTraceArgs {
  const void* positions;
  const void* directions;
  const double* params;
  void* samples;
  int cap;
  int* flags;
  int* n_samples;
  long long n_rays;
  cudaStream_t stream;
};

struct PolSampleArgs {
  const void* samples;
  int cap;
  const int* n_samples;
  const long long* offsets;
  int n_warps;
  long long n_rays;

  template <typename T>
  SampleSet<T> view() const {
    return {static_cast<const T*>(samples), cap, n_samples, offsets, n_warps, n_rays};
  }
};

struct PolDeriveArgs {
  PolSampleArgs set;
  long long n_slots;
  bool geometry;
  const void* directions;
  const void* momentum_factors;
  const void* freqs;
  int nf;
  const double* params;
  SimGridArgs grid;
  void* geometry_records;
  void* coefficient_records;
  int* bad;
  cudaStream_t stream;
};

struct PolChainArgs {
  PolSampleArgs set;
  const int* order;
  const void* geometry_records;
  const void* coefficient_records;
  int nf;
  const double* params;
  void* nn;
  cudaStream_t stream;
};

template <typename T, int INTEGRATOR>
cudaError_t launch_polarized_trace(const PolTraceArgs& a) {
  const unsigned blocks = static_cast<unsigned>((a.n_rays + POL_THREADS - 1) / POL_THREADS);
  polarized_trace_kernel<T, INTEGRATOR><<<blocks, POL_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.positions), static_cast<const T*>(a.directions), a.params,
      static_cast<T*>(a.samples), a.cap, a.flags, a.n_samples, a.n_rays);
  return cudaGetLastError();
}

// MODE SAMPLE_SINGLE launches polarized_derive_kernel, SAMPLE_FMKS
// polarized_derive_fmks_kernel, the others (the CKS modes too)
// polarized_derive_mode_kernel; POP_MIXTURE polarized_derive_mixture_kernel.
template <typename T, int MODE = SAMPLE_SINGLE, int POP = POP_THERMAL>
cudaError_t launch_polarized_derive(const PolDeriveArgs& a) {
  const long long threads = a.n_slots * POL_WARP;
  const unsigned blocks = static_cast<unsigned>((threads + POL_THREADS - 1) / POL_THREADS);
  if constexpr (POP == POP_MIXTURE) {
    auto kernel = a.geometry ? polarized_derive_mixture_kernel<T, true, MODE>
                             : polarized_derive_mixture_kernel<T, false, MODE>;
    kernel<<<blocks, POL_THREADS, 0, a.stream>>>(
        a.set.view<T>(), a.n_slots, static_cast<const T*>(a.directions),
        static_cast<const T*>(a.momentum_factors), static_cast<const T*>(a.freqs), a.nf,
        a.params, grid_view_of<T, MODE>(a.grid), a.grid.kappa,
        static_cast<T*>(a.geometry_records), static_cast<T*>(a.coefficient_records), a.bad);
  } else if constexpr (MODE == SAMPLE_SINGLE) {
    auto kernel =
        a.geometry ? polarized_derive_kernel<T, true> : polarized_derive_kernel<T, false>;
    kernel<<<blocks, POL_THREADS, 0, a.stream>>>(
        a.set.view<T>(), a.n_slots, static_cast<const T*>(a.directions),
        static_cast<const T*>(a.momentum_factors), static_cast<const T*>(a.freqs), a.nf,
        a.params, a.grid.view<T>(), static_cast<T*>(a.geometry_records),
        static_cast<T*>(a.coefficient_records), a.bad);
  } else if constexpr (MODE == SAMPLE_FMKS) {
    auto kernel = a.geometry ? polarized_derive_fmks_kernel<T, true>
                             : polarized_derive_fmks_kernel<T, false>;
    kernel<<<blocks, POL_THREADS, 0, a.stream>>>(
        a.set.view<T>(), a.n_slots, static_cast<const T*>(a.directions),
        static_cast<const T*>(a.momentum_factors), static_cast<const T*>(a.freqs), a.nf,
        a.params, a.grid.fmks_view<T>(), static_cast<T*>(a.geometry_records),
        static_cast<T*>(a.coefficient_records), a.bad);
  } else {
    auto kernel = a.geometry ? polarized_derive_mode_kernel<T, true, MODE>
                             : polarized_derive_mode_kernel<T, false, MODE>;
    kernel<<<blocks, POL_THREADS, 0, a.stream>>>(
        a.set.view<T>(), a.n_slots, static_cast<const T*>(a.directions),
        static_cast<const T*>(a.momentum_factors), static_cast<const T*>(a.freqs), a.nf,
        a.params, a.grid.block_view<T>(), static_cast<T*>(a.geometry_records),
        static_cast<T*>(a.coefficient_records), a.bad);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_polarized_chain(const PolChainArgs& a) {
  constexpr int warps_per_block = POL_THREADS / POL_WARP;
  const unsigned blocks = static_cast<unsigned>((a.set.n_warps + warps_per_block - 1) /
                                                warps_per_block);
  auto kernel = a.nf == 1 ? polarized_chain_kernel<T, 1>
                          : polarized_chain_kernel<T, POL_MAX_FREQUENCIES>;
  kernel<<<blocks, POL_THREADS, 0, a.stream>>>(
      a.set.view<T>(), a.order, static_cast<const T*>(a.geometry_records),
      static_cast<const T*>(a.coefficient_records), a.nf, a.params, static_cast<T*>(a.nn));
  return cudaGetLastError();
}

// The trace kernel for every type and integrator (polarized_trace.cu) and
// the derive kernel in each type (polarized_derive.cu,
// polarized_derive_f64.cu).
cudaError_t launch_polarized_trace_any(int dtype_code, int integrator, const PolTraceArgs& a);
cudaError_t launch_polarized_derive_f32(const PolDeriveArgs& a);
cudaError_t launch_polarized_derive_f64(const PolDeriveArgs& a);
// The derive kernel on many blocks (a.grid.mode SAMPLE_BLOCKS or
// SAMPLE_INTERBLOCK) in either type (polarized_derive_blocks.cu).
cudaError_t launch_polarized_derive_blocks(int dtype_code, const PolDeriveArgs& a);
// The mixture's derive kernel on one block in float
// (polarized_derive_mixture.cu, with its C interface) and double
// (polarized_derive_mixture_f64.cu), and on many blocks in either
// (polarized_derive_mixture_blocks.cu).
cudaError_t launch_polarized_derive_mixture_f64(const PolDeriveArgs& a);
cudaError_t launch_polarized_derive_mixture_blocks(int dtype_code, const PolDeriveArgs& a);
// The derive kernel on one FMKS block (a.grid.mode SAMPLE_FMKS), thermal
// (pop POP_THERMAL) or the mixture (POP_MIXTURE): float in
// polarized_derive_fmks.cu, double in polarized_derive_fmks_f64.cu.
cudaError_t launch_polarized_derive_fmks(int dtype_code, int pop, const PolDeriveArgs& a);
cudaError_t launch_polarized_derive_fmks_f64(int pop, const PolDeriveArgs& a);
// The derive kernel on a CKS grid (a.grid.mode SAMPLE_CKS_BLOCKS or
// SAMPLE_CKS_INTERBLOCK), thermal or the mixture: float in
// polarized_derive_cks.cu, double in polarized_derive_cks_f64.cu.
cudaError_t launch_polarized_derive_cks(int dtype_code, int pop, const PolDeriveArgs& a);
cudaError_t launch_polarized_derive_cks_f64(int pop, const PolDeriveArgs& a);

}  // namespace bl
