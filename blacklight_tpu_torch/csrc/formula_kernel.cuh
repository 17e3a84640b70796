// Fused formula-model ray tracer for NVIDIA Hopper (sm_90a): geodesic step,
// formula coefficients and unpolarized transfer for one ray per thread, at
// one or several frequencies, optionally carrying forward tangents dI/dp of
// the emission parameters (cn0, r0, h).
//
// Replaces the TPU kernel blacklight_tpu/ops/pallas_formula.py:_make_kernel
// (:192-596, launched by render_formula :599-697): K1.1/K1.2 (one
// frequency), K1.3 (len(nus) > 1) and K1.4 (diff_params). The dp body
// follows :363-485, the rk4/rk2 body :487-578, the sample and transfer
// update transfer_update :270-355 (tangents :322-354) and the finalization
// :582-594. The step loop is trace.cuh's trace_ray, shared with the
// simulation kernel; this file supplies the formula coefficients and the
// transfer update at each stored sample.
//
// Frequencies: the geometry of a sample (velocity, density profile, u.k) is
// shared; each frequency adds its power laws and an (I, tau) pair. NF = 1
// and NF = FORMULA_MAX_FREQUENCIES are the two compile-time buckets: the
// accumulators of a bucket stay in registers (every loop over them is
// unrolled), and a launch with nf < NF leaves the rest idle. The host
// launches once per FORMULA_MAX_FREQUENCIES frequencies beyond that, each
// launch retracing the rays.
//
// Tangents (TANGENTS): the trajectory does not depend on cn0, r0 or h, so
// dI/dp and dtau/dp ride along the same loop, one pair per parameter and
// frequency, read from the bits of diff_mask (DiffParam order) and
// indexed by parameter so that every index is a compile-time constant. The
// runtime values theta (one per set bit, in the rays' type, in device
// memory) replace the fixed cn0, r0 and h in the coefficients too. Weights:
// alpha is linear in cn0 (d alpha = alpha_unit, dj = 0); j and alpha both
// scale with the Gaussian density profile, whose log-derivatives are
// w_r0 = r^2 / r0^3 and w_h = -h cos^2(theta). The tangent arithmetic is
// written in the plain version's forms, operation for operation.
//
// What bounds it on this card: FP32 (or FP64) ALU work and register
// pressure. A ray reads 9 values and writes 2 + F (1 + nd) over thousands
// of steps, so device-memory traffic is negligible. A dp step is seven
// right-hand sides (about 60 operations each, with divisions and square
// roots), an error norm and two null renormalizations; the seven stages are
// held in registers (49 values), and the double instantiations may spill
// to local memory (-Xptxas -v reports it). Each extra frequency adds ~50
// operations to a sample and each tangent ~25 per frequency
// (chip_smoke.py FORMULA_OPS_PER_FREQUENCY, FORMULA_OPS_PER_TANGENT).
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
// The instantiations live in translation units built with different
// multiply-add contraction (ops/_build.py): formula_kernel.cu,
// formula_kernel_multi.cu and formula_kernel_tangent.cu hold rk4 and rk2
// without contraction, so that they round as the plain version does step
// by step; the *_dp.cu units hold dp with contraction, whose agreement with
// the plain version is statistical in any case.

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
constexpr int FORMULA_MAX_FREQUENCIES = 4;  // the larger frequency bucket
constexpr double DELTA_TAU_MAX = 100.0;     // unpolarized.cpp:96-110

// Parameters that can carry tangents; bit k of a launch's diff_mask selects
// DiffParam k, and theta holds one value per set bit in this order.
enum DiffParam : int { D_CN0, D_R0, D_H, D_COUNT };

// Formula-model constants of one launch (FormulaParams and the frequency
// blocks of its first nf <= NF frequencies).
template <typename T, int NF>
struct FormulaConsts {
  T bh_a, a2, two_a, two_m, neg_two_m_a, camera_r, l0, one_plus_q, inv_r0_sq;
  T h_sq, inv_nup, a_param, cn0, ej, ej_sign, ea, ea_sign;
  bool ej_int, ea_int;
  CutConsts<T> cuts;
  T cam[4];
  T nu[NF], x_unit_over_nu[NF];

  __device__ FormulaConsts(const double* p, int nf) : cuts(p + P_CUT_NEAR) {
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
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const bool on = NF == 1 || f < nf;
      nu[f] = on ? T(p[P_COUNT + f * PF_COUNT + PF_NU]) : T(0);
      x_unit_over_nu[f] = on ? T(p[P_COUNT + f * PF_COUNT + PF_X_UNIT_OVER_NU]) : T(0);
    }
  }
};

// The values of cn0, r0 and h the coefficients use: theta's where a
// parameter carries a tangent, else the launch's constants (r0 and h then
// enter only through inv_r0_sq and h_sq, in the plain version's forms).
template <typename T>
struct Emission {
  T cn0, r0, h;
  bool runtime_r0, runtime_h;
};

// C++ pow with a constant exponent e for a possibly negative base
// (pallas_formula.py:159-175): sign^e |x|^e for integer e, 0 at x == 0.
template <typename T>
__device__ __forceinline__ T cpp_pow(T x, T e, bool is_int, T sign) {
  if (x > T(0)) return m_pow(x, e);
  if (is_int && x < T(0)) return sign * m_pow(-x, e);
  return T(0);
}

// The frequency-independent part of a sample: _formula_geom_c (:68-144).
template <typename T>
struct FormulaGeom {
  T n_n0, u_dot_k, r, cth;
  bool keep, bad;  // bad: the disk velocity is not timelike
};

template <typename T, int NF>
__device__ __forceinline__ FormulaGeom<T> formula_geometry(const FormulaConsts<T, NF>& c,
                                                           const Emission<T>& em, T x1,
                                                           T x2, T x3, T k0, T k1, T k2,
                                                           T k3) {
  const T a = c.bh_a;
  const T rr2 = x1 * x1 + x2 * x2 + x3 * x3;
  const T r = m_sqrt(T(0.5) * (rr2 - c.a2 + m_hypot(rr2 - c.a2, c.two_a * x3)));

  FormulaGeom<T> g;
  g.keep = geometric_keep(c.cuts, x1, x2, x3, r, c.camera_r, c.cam[1], c.cam[2], c.cam[3]);

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
  g.bad = !(u_arg > T(0));
  const T u_norm = T(1) / m_sqrt(u_arg > T(0) ? u_arg : T(1));
  const T u_t = -u_norm;
  const T u_ph = u_norm * ll;
  const T u0 = gtt * u_t + gtph * u_ph;
  const T uph = gtph * u_t + gphph * u_ph;
  const T u1 = sth * (-r * sph - a * cph) * uph;
  const T u2 = sth * (r * cph - a * sph) * uph;
  const T radial = em.runtime_r0 ? r * r / (em.r0 * em.r0) : r * r * c.inv_r0_sq;
  const T h_sq = em.runtime_h ? em.h * em.h : c.h_sq;
  g.n_n0 = m_exp(T(-0.5) * (radial + h_sq * cth * cth));
  g.u_dot_k = u0 * k0 + u1 * k1 + u2 * k2 + T(0) * k3;
  g.r = r;
  g.cth = cth;
  return g;
}

// Invariant j (in units of cn0/nup^2), alpha and alpha_unit = d alpha /
// d cn0 at frequency nu, with the cut mask applied, and whether the sample
// is bad (C++ would give NaN): _formula_jalpha_c (:147-186).
template <typename T, int NF>
__device__ __forceinline__ void formula_jalpha(const FormulaConsts<T, NF>& c,
                                               const FormulaGeom<T>& g, T mom, T nu, T cn0,
                                               T& j_out, T& alpha_out, T& alpha_unit_out,
                                               bool& bad_out) {
  const T nu_fluid = -g.u_dot_k * nu * mom;
  const T x_raw = nu_fluid * c.inv_nup;
  const T pj = cpp_pow(x_raw, c.ej, c.ej_int, c.ej_sign);
  bool bad = g.bad;
  if (!c.ej_int) bad = bad || (x_raw < T(0));
  // a non-integer alpha exponent of a negative base routes to the j-only
  // branch like alpha = 0
  const T pa = cpp_pow(x_raw, c.ea, c.ea_int, c.ea_sign);
  const T j = g.n_n0 * pj;
  const T alpha_unit = c.a_param * g.n_n0 * pa * nu_fluid;
  const T alpha = cn0 * alpha_unit;
  j_out = g.keep ? j : T(0);
  alpha_out = g.keep ? alpha : T(0);
  alpha_unit_out = g.keep ? alpha_unit : T(0);
  bad_out = bad && g.keep;
}

// The accumulators of one ray and the transfer update at each of its
// stored samples (transfer_update, :270-355): the invariant source-function
// recurrence with the optically thick trap, per frequency, and the forward
// tangents of (I, tau) where TANGENTS.
template <typename T, int NF, bool TANGENTS>
struct FormulaSample {
  static constexpr int ND = TANGENTS ? D_COUNT : 1;
  const FormulaConsts<T, NF>& c;
  Emission<T> em;
  unsigned diff_mask;
  int nf;
  T p0, mom;
  T intensity[NF], tau[NF];
  T d_intensity[ND][NF], d_tau[ND][NF];  // indexed by DiffParam
  bool bad;

  __device__ FormulaSample(const FormulaConsts<T, NF>& c_, const T* __restrict__ theta,
                           unsigned diff_mask_, int nf_, T p0_, T mom_)
      : c(c_), diff_mask(TANGENTS ? diff_mask_ : 0u), nf(nf_), p0(p0_), mom(mom_),
        bad(false) {
    em.cn0 = c.cn0;
    em.r0 = T(1);
    em.h = T(0);
    em.runtime_r0 = false;
    em.runtime_h = false;
    if (TANGENTS) {
      int slot = 0;
      if (diff(D_CN0)) em.cn0 = theta[slot++];
      if (diff(D_R0)) {
        em.r0 = theta[slot++];
        em.runtime_r0 = true;
      }
      if (diff(D_H)) {
        em.h = theta[slot++];
        em.runtime_h = true;
      }
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      intensity[f] = T(0);
      tau[f] = T(0);
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        d_intensity[k][f] = T(0);
        d_tau[k][f] = T(0);
      }
    }
  }

  __device__ __forceinline__ bool diff(int k) const {
    return TANGENTS && ((diff_mask >> k) & 1u);
  }
  __device__ __forceinline__ bool on(int f) const { return NF == 1 || f < nf; }

  __device__ __forceinline__ void operator()(const T (&ym)[7], T k1, T k2, T k3, T h) {
    const FormulaGeom<T> g = formula_geometry(c, em, ym[1], ym[2], ym[3], p0, k1, k2, k3);
    T w_r0 = T(0), w_h = T(0);
    if (TANGENTS) {
      // log-derivatives of the density profile wrt r0 and h
      w_r0 = g.r * g.r / (em.r0 * em.r0 * em.r0);
      w_h = -em.h * g.cth * g.cth;
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (on(f)) update(f, g, h, w_r0, w_h);
    }
  }

  __device__ __forceinline__ void update(int f, const FormulaGeom<T>& g, T h, T w_r0,
                                         T w_h) {
    T j, alpha, alpha_unit;
    bool cbad;
    formula_jalpha(c, g, mom, c.nu[f], em.cn0, j, alpha, alpha_unit, cbad);
    cbad = cbad || !(m_isfinite(j) && m_isfinite(alpha));
    if (cbad) {
      j = T(0);
      alpha = T(0);
      alpha_unit = T(0);
    }
    bad = bad || cbad;

    const T dl_cgs = (-h) * c.x_unit_over_nu[f] / mom;
    const bool pos_alpha = alpha > T(0);
    const T ss = j / (pos_alpha ? alpha : T(1));
    const T delta_tau = alpha * dl_cgs;
    const T atten = m_exp(-tau[f]);
    const bool thin = delta_tau <= T(DELTA_TAU_MAX);
    const T em1 = -m_expm1(-delta_tau);
    const T contrib = pos_alpha ? (thin ? ss * em1 : ss) : j * dl_cgs;
    if (TANGENTS) {
      // dss divides by alpha rather than multiply by 1 / alpha (the TPU
      // kernel's form): far out in the disk's Gaussian tail a float32
      // alpha is subnormal and its reciprocal overflows, where the
      // quotient of the two small numbers stays finite
      const T alpha_or_1 = pos_alpha ? alpha : T(1);
      const T exp_neg_dt = m_exp(-delta_tau);
#pragma unroll
      for (int k = 0; k < D_COUNT; ++k) {
        if (!diff(k)) continue;
        // tangent of (j, alpha): j does not depend on cn0
        const bool is_cn0 = k == D_CN0;
        const T w = k == D_R0 ? w_r0 : w_h;
        const T dj = is_cn0 ? T(0) : j * w;
        const T dalpha = is_cn0 ? alpha_unit : alpha * w;
        const T ddt = dalpha * dl_cgs;
        const T dss = (is_cn0 ? -ss * dalpha : dj - ss * dalpha) / alpha_or_1;
        const T dcontrib = pos_alpha ? (thin ? dss * em1 + ss * exp_neg_dt * ddt : dss)
                                     : (is_cn0 ? T(0) : dj * dl_cgs);
        // tau == inf => atten == 0: later contributions and their tangents
        // vanish (the guard avoids 0 * inf)
        const T datten = atten > T(0) ? -atten * d_tau[k][f] : T(0);
        d_intensity[k][f] = d_intensity[k][f] + (dcontrib * atten + contrib * datten);
        if (pos_alpha && thin) d_tau[k][f] = d_tau[k][f] + ddt;
      }
    }
    intensity[f] = intensity[f] + contrib * atten;
    tau[f] = tau[f] + (pos_alpha ? (thin ? delta_tau : T(INFINITY)) : T(0));
  }
};

// i_nu: (n_rays, ld) row-major, this launch's frequencies at columns
// [0, nf); d_i_nu (TANGENTS): (nd, n_rays, ld), one plane per set bit of
// diff_mask in DiffParam order.
template <typename T, int INTEGRATOR, int NF, bool TANGENTS>
__global__ void __launch_bounds__(THREADS)
    formula_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                   const T* __restrict__ momentum_factors,
                   const double* __restrict__ params, const T* __restrict__ theta, int nf,
                   unsigned diff_mask, int ld, T* __restrict__ i_nu, T* __restrict__ d_i_nu,
                   int* __restrict__ flags_out, int* __restrict__ n_samples_out,
                   long long n_rays) {
  const long long ray = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  const TraceConsts<T> tc(params);
  const FormulaConsts<T, NF> fc(params, nf);

  // state: x^0..x^3, p_1..p_3 (p_0 is conserved)
  RayState<T> s;
  init_ray_state(tc, positions + 4 * ray, directions + 4 * ray, s);
  const T p0 = directions[4 * ray + 0];

  FormulaSample<T, NF, TANGENTS> sample(fc, theta, diff_mask, nf, p0, momentum_factors[ray]);
  bool flag;
  int n_samp;
  trace_ray<T, INTEGRATOR>(tc, s, p0, sample, flag, n_samp);

  // one bad mask for all frequencies, as the TPU kernel keeps it
  const bool poison = sample.bad || (tc.fallback_nan && flag);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (!sample.on(f)) continue;
    const T i_scale = T(params[P_COUNT + f * PF_COUNT + PF_I_SCALE]);
    i_nu[ray * ld + f] = poison ? T(NAN) : sample.intensity[f] * i_scale;
    if (TANGENTS) {
      // a poisoned pixel holds a constant NaN: its derivative is zero
      int slot = 0;
#pragma unroll
      for (int k = 0; k < D_COUNT; ++k) {
        if (!sample.diff(k)) continue;
        d_i_nu[(slot * n_rays + ray) * ld + f] =
            poison ? T(0) : sample.d_intensity[k][f] * i_scale;
        ++slot;
      }
    }
  }
  flags_out[ray] = flag ? 1 : 0;
  n_samples_out[ray] = n_samp;
}

// Pointers and sizes of one launch, as the C interface receives them.
struct LaunchArgs {
  const void* positions;
  const void* directions;
  const void* momentum_factors;
  const double* params;
  const void* theta;
  int nf;
  unsigned diff_mask;
  int ld;
  void* i_nu;
  void* d_i_nu;
  int* flags;
  int* n_samples;
  long long n_rays;
  cudaStream_t stream;
};

template <typename T, int INTEGRATOR, int NF, bool TANGENTS>
cudaError_t launch(const LaunchArgs& a) {
  const unsigned blocks = static_cast<unsigned>((a.n_rays + THREADS - 1) / THREADS);
  formula_kernel<T, INTEGRATOR, NF, TANGENTS><<<blocks, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.positions), static_cast<const T*>(a.directions),
      static_cast<const T*>(a.momentum_factors), a.params, static_cast<const T*>(a.theta),
      a.nf, a.diff_mask, a.ld, static_cast<T*>(a.i_nu), static_cast<T*>(a.d_i_nu), a.flags,
      a.n_samples, a.n_rays);
  return cudaGetLastError();
}

// float (dtype_code 0) or double (1)
template <int INTEGRATOR, int NF, bool TANGENTS>
cudaError_t launch_typed(int dtype_code, const LaunchArgs& a) {
  if (dtype_code == 0) return launch<float, INTEGRATOR, NF, TANGENTS>(a);
  if (dtype_code == 1) return launch<double, INTEGRATOR, NF, TANGENTS>(a);
  return cudaErrorInvalidValue;
}

template <int NF, bool TANGENTS>
cudaError_t launch_rk(int dtype_code, int integrator, const LaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_typed<INTEGRATOR_RK4, NF, TANGENTS>(dtype_code, a);
    case INTEGRATOR_RK2:
      return launch_typed<INTEGRATOR_RK2, NF, TANGENTS>(dtype_code, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The units besides formula_kernel.cu, each built on its own (ops/_build.py):
// dp at one frequency without tangents (formula_kernel_dp.cu), the larger
// frequency bucket without tangents (formula_kernel_multi{,_dp}.cu) and
// both buckets with tangents (formula_kernel_tangent{,_dp}.cu).
cudaError_t launch_dp(int dtype_code, const LaunchArgs& a);
cudaError_t launch_multi_rk(int dtype_code, int integrator, const LaunchArgs& a);
cudaError_t launch_multi_dp(int dtype_code, const LaunchArgs& a);
cudaError_t launch_tangent_rk(int dtype_code, int integrator, const LaunchArgs& a);
cudaError_t launch_tangent_dp(int dtype_code, const LaunchArgs& a);

}  // namespace bl
