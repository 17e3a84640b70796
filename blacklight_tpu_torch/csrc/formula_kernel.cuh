// Fused formula-model ray tracer for NVIDIA Hopper (sm_90a): geodesic step,
// formula coefficients and unpolarized transfer for one ray per thread.
//
// Replaces the TPU kernel blacklight_tpu/ops/pallas_formula.py:_make_kernel
// (:192-596, launched by render_formula :599-697) for one frequency without
// tangents. The dp body follows :363-485, the rk4/rk2 body :487-578, the
// sample and transfer update transfer_update :270-355 and the finalization
// :582-594. The step loop is trace.cuh's trace_ray, shared with the
// simulation kernel; this file supplies the formula coefficients and the
// transfer update at each stored sample.
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

#include "cuts.cuh"
#include "formula_params.cuh"
#include "trace.cuh"

namespace bl {

static_assert(P_FALLBACK_NAN == G_FALLBACK_NAN && P_F_BH_A == G_COUNT,
              "the formula parameters open with the geodesic block");
static_assert(P_PLANE_NZ - P_CUT_NEAR == C_PLANE_NZ,
              "the formula parameters hold the cut block in cuts.cuh order");

constexpr int THREADS = 128;
constexpr double DELTA_TAU_MAX = 100.0;  // unpolarized.cpp:96-110

// Formula-model constants of one launch (FormulaParams plus frequency).
template <typename T>
struct FormulaConsts {
  T bh_a, a2, two_a, two_m, neg_two_m_a, camera_r, l0, one_plus_q, inv_r0_sq;
  T h_sq, inv_nup, a_param, cn0, ej, ej_sign, ea, ea_sign;
  bool ej_int, ea_int;
  CutConsts<T> cuts;
  T cam[4];
  T nu, x_unit_over_nu;

  __device__ explicit FormulaConsts(const double* p) : cuts(p + P_CUT_NEAR) {
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

  const bool keep = geometric_keep(c.cuts, x1, x2, x3, r, c.camera_r, c.cam[1],
                                   c.cam[2], c.cam[3]);

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
  const TraceConsts<T> tc(params);
  const T i_scale = T(params[P_I_SCALE]);
  const FormulaConsts<T> fc(params);

  // state: x^0..x^3, p_1..p_3 (p_0 is conserved)
  RayState<T> s;
  init_ray_state(tc, positions + 4 * ray, directions + 4 * ray, s);
  const T p0 = directions[4 * ray + 0];
  const T mom = momentum_factors[ray];

  T intensity = T(0), tau = T(0);
  bool bad = false, flag;
  int n_samp;
  auto on_sample = [&](const T (&ym)[7], T k1, T k2, T k3, T hs) {
    transfer_sample(fc, ym[1], ym[2], ym[3], p0, k1, k2, k3, mom, hs, intensity, tau,
                    bad);
  };
  trace_ray<T, INTEGRATOR>(tc, s, p0, on_sample, flag, n_samp);

  const bool poison = bad || (tc.fallback_nan && flag);
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
