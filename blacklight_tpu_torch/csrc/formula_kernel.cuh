// Fused formula-model ray tracer for NVIDIA Hopper (sm_90a): geodesic step,
// formula coefficients and unpolarized transfer for one ray per thread at a
// time, at one or several frequencies, optionally carrying forward tangents
// dI/dp of the emission parameters (cn0, r0, h).
//
// Replaces the TPU kernel blacklight_tpu/ops/pallas_formula.py:_make_kernel
// (:192-596, launched by render_formula :599-697): K1.1/K1.2 (one
// frequency), K1.3 (len(nus) > 1) and K1.4 (diff_params). The dp body
// follows :363-485, the rk4/rk2 body :487-578, the sample and transfer
// update transfer_update :270-355 (tangents :322-354) and the finalization
// :582-594. The plain PyTorch version is
// blacklight_tpu_torch/ops/formula_kernel.py render_formula_reference.
//
// What bounds it on this card: issuing its instructions, then the latency
// of its arithmetic at the occupancy its registers allow. A ray reads 9
// values and writes 2 + F (1 + nd) over thousands of steps, so device
// memory traffic is negligible. A dp step is seven right-hand sides (about
// 60 operations each, with IEEE divisions and square roots, each of which
// branches around a slow path), an error norm and two null
// renormalizations: ~4,300 instructions on the float per-step path for
// ~2,150 counted operations (scripts/sass_step_mix.py, PERF.md §6); the
// seven stages are 49 live values. Each extra
// frequency adds ~50 operations to a sample and each tangent ~25 per
// frequency (chip_smoke.py FORMULA_OPS_PER_FREQUENCY,
// FORMULA_OPS_PER_TANGENT).
//
// What the design does about it:
// - Launch constants in the constant bank. Every geodesic, formula, cut
//   and frequency constant arrives rounded to T by the host
//   (FormulaLaunchConsts, packed by ops/formula_kernel.py launch_consts)
//   as a kernel parameter passed by value, as the TPU kernel bakes them
//   into its closure. Arithmetic reads them as constant-bank operands, so
//   none of them holds a register across the step loop. theta (tangents)
//   stays in device memory: a fit step never waits on the host.
// - The step carries its endpoint geometry (formula_step). Dormand-Prince's
//   7th stage is evaluated at the 5th-order endpoint (DP_A[6] is DP_B5,
//   summed alike), and an accepted step keeps that position; its
//   Kerr-Schild derivatives (r, f, l, df, dl) become the next step's first
//   stage and its f, l the endpoint's renormalization, in place of
//   recomputing them. rk4/rk2 carry r alone. At the sample point, r is
//   computed once for the renormalization, the truncation test and
//   formula_geometry. The same arithmetic in the same forms, so the units
//   without contraction give the bits of trace.cuh's step_ray.
// - Persistent lanes. The grid is the card's resident block count (or what
//   the bundle needs, if fewer); when a lane's ray ends it writes that
//   ray's outputs at the ray's own index and takes the next ray slot from
//   a device counter, one warp-aggregated atomicAdd for all lanes of the
//   warp that need one. A block no longer holds its SM until its longest
//   ray ends; only the last rays leave lanes idle. A ray's arithmetic does
//   not depend on its lane, so the outputs equal a launch without fetch,
//   bit for bit, from run to run. Rays are fetched in their order in the
//   bundle; the wrapper's caller picks that order.
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

#include <cstring>

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
constexpr unsigned FULL_WARP = 0xffffffffu;

// At least FormulaBlocks<T> blocks of THREADS per SM (__launch_bounds__):
// float holds every instantiation to 80 registers, 24 warps an SM, and
// spills the rest to local memory, which the L1 cache holds: the kernel
// waits on the latency of its arithmetic, and more warps hide more of it
// than the spills cost (PERF.md §6: k = 3, 4, 5, 6 timed in turns; dp
// float32 0.953x of k = 4's 128 registers, which do not spill, three
// frequencies with three tangents 0.97x, rk4 and rk2 a tie; the stage
// vectors in shared memory were slower at k = 5, 6 and 7). The double
// builds take what they need, at most 255.
template <typename T>
constexpr int FormulaBlocks = sizeof(T) == 4 ? 6 : 1;
constexpr double DELTA_TAU_MAX = 100.0;     // unpolarized.cpp:96-110

// Parameters that can carry tangents; bit k of a launch's diff_mask selects
// DiffParam k, and theta holds one value per set bit in this order.
enum DiffParam : int { D_CN0, D_R0, D_H, D_COUNT };

// The launch constants, rounded once to T on the host: the FormulaParam
// block, then NF FrequencyParam blocks (zero beyond the launch's nf).
// Passed by value as a kernel parameter, they live in the constant bank.
template <typename T, int NF>
struct FormulaLaunchConsts {
  T v[P_COUNT + NF * PF_COUNT];
};

// Formula-model constants of one launch (FormulaParams and the frequency
// blocks of its first nf <= NF frequencies), read from the launch
// constants: copies of kernel parameters, which the compiler reads from
// the constant bank where they are used.
template <typename T, int NF>
struct FormulaConsts {
  T bh_a, a2, two_a, two_m, neg_two_m_a, camera_r, l0, one_plus_q, inv_r0_sq;
  T h_sq, inv_nup, a_param, cn0, ej, ej_sign, ea, ea_sign;
  bool ej_int, ea_int;
  CutConsts<T> cuts;
  T cam[4];
  T nu[NF], x_unit_over_nu[NF], i_scale[NF];

  __device__ explicit FormulaConsts(const T* p) : cuts(p + P_CUT_NEAR) {
    bh_a = p[P_F_BH_A];
    a2 = p[P_F_A2];
    two_a = p[P_F_TWO_A];
    two_m = p[P_F_TWO_M];
    neg_two_m_a = p[P_F_NEG_TWO_M_A];
    camera_r = p[P_F_CAMERA_R];
    l0 = p[P_F_L0];
    one_plus_q = p[P_F_ONE_PLUS_Q];
    inv_r0_sq = p[P_F_INV_R0_SQ];
    h_sq = p[P_F_H_SQ];
    inv_nup = p[P_F_INV_NUP];
    a_param = p[P_F_A_PARAM];
    cn0 = p[P_F_CN0];
    ej = p[P_EJ];
    ej_int = flag_at<T>(p, P_EJ_IS_INT);
    ej_sign = p[P_EJ_SIGN];
    ea = p[P_EA];
    ea_int = flag_at<T>(p, P_EA_IS_INT);
    ea_sign = p[P_EA_SIGN];
    cam[0] = p[P_CAM_X0];
    cam[1] = p[P_CAM_X1];
    cam[2] = p[P_CAM_X2];
    cam[3] = p[P_CAM_X3];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      nu[f] = p[P_COUNT + f * PF_COUNT + PF_NU];
      x_unit_over_nu[f] = p[P_COUNT + f * PF_COUNT + PF_X_UNIT_OVER_NU];
      i_scale[f] = p[P_COUNT + f * PF_COUNT + PF_I_SCALE];
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

template <typename T, int NF, bool TANGENTS>
__device__ __forceinline__ Emission<T> emission(const FormulaConsts<T, NF>& c,
                                                const T* __restrict__ theta,
                                                unsigned diff_mask) {
  Emission<T> em;
  em.cn0 = c.cn0;
  em.r0 = T(1);
  em.h = T(0);
  em.runtime_r0 = false;
  em.runtime_h = false;
  if (TANGENTS) {
    int slot = 0;
    if ((diff_mask >> D_CN0) & 1u) em.cn0 = theta[slot++];
    if ((diff_mask >> D_R0) & 1u) {
      em.r0 = theta[slot++];
      em.runtime_r0 = true;
    }
    if ((diff_mask >> D_H) & 1u) {
      em.h = theta[slot++];
      em.runtime_h = true;
    }
  }
  return em;
}

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

// r is the sample's Kerr-Schild radius, which formula_step computed once
// (the geodesic's spin and a^2 are the formula model's: both come from
// formula_spin).
template <typename T, int NF>
__device__ __forceinline__ FormulaGeom<T> formula_geometry(const FormulaConsts<T, NF>& c,
                                                           const Emission<T>& em, T x1,
                                                           T x2, T x3, T r, T k0, T k1, T k2,
                                                           T k3) {
  const T a = c.bh_a;

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
// tangents of (I, tau) where TANGENTS. reset() starts a ray.
template <typename T, int NF, bool TANGENTS>
struct FormulaSample {
  static constexpr int ND = TANGENTS ? D_COUNT : 1;
  const FormulaConsts<T, NF>& c;
  const Emission<T> em;
  const unsigned diff_mask;
  const int nf;
  T p0, mom;
  T intensity[NF], tau[NF];
  T d_intensity[ND][NF], d_tau[ND][NF];  // indexed by DiffParam
  bool bad;

  __device__ FormulaSample(const FormulaConsts<T, NF>& c_, const Emission<T>& em_,
                           unsigned diff_mask_, int nf_)
      : c(c_), em(em_), diff_mask(TANGENTS ? diff_mask_ : 0u), nf(nf_) {}

  __device__ __forceinline__ void reset(T p0_, T mom_) {
    p0 = p0_;
    mom = mom_;
    bad = false;
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

  __device__ __forceinline__ void operator()(const T (&ym)[7], T k1, T k2, T k3, T h, T r) {
    const FormulaGeom<T> g =
        formula_geometry(c, em, ym[1], ym[2], ym[3], r, p0, k1, k2, k3);
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

// The geometry a ray carries from one step to the next: the Kerr-Schild
// derivatives at its position y (dp), or its radius alone (rk4, rk2 and the
// flat metric). start_geometry sets them at the camera.
template <typename T, int INTEGRATOR>
__device__ __forceinline__ void start_geometry(const KerrConsts<T>& g, const T (&y)[7],
                                               KsDerivs<T>& here) {
  if (INTEGRATOR == INTEGRATOR_DP && !g.flat) {
    ks_derivatives(y[1], y[2], y[3], g, here);
  } else {
    here.r = ks_radius(y[1], y[2], y[3], g);
  }
}

// trace.cuh's step_ray with the geometry carried in `here` (start_geometry):
// the same stages, controller and end of step (trace.cuh rk_stages,
// dp_step_size, dp_control, end_step) on the same values. dp's first stage
// takes the carried derivatives, its 7th stage leaves those of the
// endpoint, whose f and l renormalize it and whose r is r_new; rk4/rk2 take
// r from the carry and compute the endpoint's once for both uses. r_mid is
// the sample point's radius, computed once for its renormalization, the
// truncation test and the sample.
template <typename T, int INTEGRATOR>
__device__ __forceinline__ bool formula_step(const TraceConsts<T>& tc, RayState<T>& s,
                                             KsDerivs<T>& here, T p0, int n, T (&ym)[7],
                                             T& k1, T& k2, T& k3, T& hs, T& r_mid) {
  const KerrConsts<T>& g = tc.g;
  const T(&y)[7] = s.y;
  const T r = here.r;
  T ye[7];  // step endpoint
  T fac, r_new;
  bool accept = true, retry_exceeded = false;

  if (INTEGRATOR == INTEGRATOR_DP) {
    T k[7][7], y4[7], ds;
    KsDerivs<T> next;
    geodesic_rhs_from(here, p0, y[4], y[5], y[6], g, k[0], &ds);
    hs = dp_step_size(tc, s, r, ds);
    dp_stages<T, true>(y, p0, hs, g, k, ye, y4, ym, &next);
    dp_control(tc, s, y, ye, y4, hs, accept, retry_exceeded);
    fac = renormalize_factor_fl(next.f, next.l1, next.l2, next.l3, p0, ye[4], ye[5], ye[6], g);
    r_new = next.r;
    // an accepted step moves to ye; a rejected one stays at y, whose
    // derivatives it recomputes (bit for bit what it had) rather than
    // holding them in registers through the seven stages
    if (accept) {
      here = next;
    } else {
      start_geometry<T, INTEGRATOR>(g, y, here);
    }
  } else {
    // fixed step h = -ray_step (r - r_horizon) (geodesics.cpp:418-795)
    hs = -tc.ray_step * (r - tc.r_horizon);
    rk_stages<T, INTEGRATOR>(g, y, p0, hs, ye, ym);
    const KsRadius<T> qe = ks_radius_parts(ye[1], ye[2], ye[3], g);
    fac = renormalize_factor_at(ye[1], ye[2], ye[3], qe, p0, ye[4], ye[5], ye[6], g);
    r_new = qe.r;
    here.r = r_new;
  }

  const KsRadius<T> qm = ks_radius_parts(ym[1], ym[2], ym[3], g);
  const T facm = renormalize_factor_at(ym[1], ym[2], ym[3], qm, p0, ym[4], ym[5], ym[6], g);
  r_mid = qm.r;
  return end_step(tc, s, n, accept, retry_exceeded, r, r_new, r_mid, fac, facm, ye, ym, k1,
                  k2, k3);
}

// One thread is a lane that traces ray after ray: first the ray of its own
// slot (block * THREADS + thread), then, each time its ray ends, the ray
// that a warp-aggregated atomicAdd on *next_slot hands it (offset by the
// grid's own rays). i_nu: (n_rays, ld) row-major, this launch's
// frequencies at columns [0, nf); d_i_nu (TANGENTS): (nd, n_rays, ld),
// one plane per set bit of diff_mask in DiffParam order; both written at
// the ray's own index. What a lane does once per ray (start_ray,
// finish_ray, take_rays) stays out of the per-step path that
// scripts/sass_step_mix.py counts.
template <typename T, int INTEGRATOR, int NF, bool TANGENTS>
__global__ void __launch_bounds__(THREADS, FormulaBlocks<T>)
    formula_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                   const T* __restrict__ momentum_factors,
                   const __grid_constant__ FormulaLaunchConsts<T, NF> consts,
                   const T* __restrict__ theta, int nf, unsigned diff_mask, int ld,
                   unsigned long long* __restrict__ next_slot, T* __restrict__ i_nu,
                   T* __restrict__ d_i_nu, int* __restrict__ flags_out,
                   int* __restrict__ n_samples_out, long long n_rays) {
  const TraceConsts<T> tc(consts.v);
  const FormulaConsts<T, NF> fc(consts.v);
  FormulaSample<T, NF, TANGENTS> sample(fc, emission<T, NF, TANGENTS>(fc, theta, diff_mask),
                                        diff_mask, nf);
  const unsigned lane = threadIdx.x & 31u;
  const long long first_fetched = static_cast<long long>(gridDim.x) * THREADS;

  RayState<T> s;
  KsDerivs<T> here;
  long long ray = 0;
  int n = 0;
  auto start_ray = [&](long long next) {
    ray = next;
    init_ray_state(tc, positions + 4 * ray, directions + 4 * ray, s);
    start_geometry<T, INTEGRATOR>(tc.g, s.y, here);
    sample.reset(directions[4 * ray + 0], momentum_factors[ray]);
    n = 0;
  };
  // the ended ray's outputs, at its own index
  auto finish_ray = [&]() {
    // one bad mask for all frequencies, as the TPU kernel keeps it
    const bool poison = sample.bad || (tc.fallback_nan && s.flag);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (!sample.on(f)) continue;
      i_nu[ray * ld + f] = poison ? T(NAN) : sample.intensity[f] * fc.i_scale[f];
      if (TANGENTS) {
        // a poisoned pixel holds a constant NaN: its derivative is zero
        int plane = 0;
#pragma unroll
        for (int k = 0; k < D_COUNT; ++k) {
          if (!sample.diff(k)) continue;
          d_i_nu[(plane * n_rays + ray) * ld + f] =
              poison ? T(0) : sample.d_intensity[k][f] * fc.i_scale[f];
          ++plane;
        }
      }
    }
    flags_out[ray] = s.flag ? 1 : 0;
    n_samples_out[ray] = s.n_samp;
  };
  // the lanes of `need` (a ballot of those whose ray ended) take the next
  // rays, one atomic a warp; returns whether this lane has a ray
  auto take_rays = [&](unsigned need, bool done, bool busy) {
    const int leader = __ffs(need) - 1;
    unsigned long long base = 0;
    if (lane == static_cast<unsigned>(leader)) {
      base = atomicAdd(next_slot, static_cast<unsigned long long>(__popc(need)));
    }
    base = __shfl_sync(FULL_WARP, base, leader);
    if (!done) return busy;
    const long long next = first_fetched + static_cast<long long>(base) +
                           __popc(need & ((1u << lane) - 1u));
    if (next >= n_rays) return false;
    start_ray(next);
    return true;
  };

  const long long own = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  bool busy = own < n_rays;
  if (busy) start_ray(own);
  while (__any_sync(FULL_WARP, busy)) {
    bool done = false;
    if (busy) {
      if (s.alive && n < tc.max_steps) {
        T ym[7], k1, k2, k3, hs, r_mid;
        if (formula_step<T, INTEGRATOR>(tc, s, here, sample.p0, n, ym, k1, k2, k3, hs,
                                        r_mid)) {
          sample(ym, k1, k2, k3, hs, r_mid);
        }
        ++n;
      }
      done = !(s.alive && n < tc.max_steps);
    }
    if (done) finish_ray();
    const unsigned need = __ballot_sync(FULL_WARP, done);
    if (need != 0u) busy = take_rays(need, done, busy);
  }
}

// Pointers and sizes of one launch, as the C interface receives them.
// consts: the host's FormulaLaunchConsts (consts_bytes long). With
// resident set, the launch only reports there how many blocks of the
// instantiation the card holds at once (blocks per SM times SMs).
struct LaunchArgs {
  const void* positions;
  const void* directions;
  const void* momentum_factors;
  const void* consts;
  long long consts_bytes;
  const void* theta;
  int nf;
  unsigned diff_mask;
  int ld;
  unsigned long long* next_slot;
  int grid;
  void* i_nu;
  void* d_i_nu;
  int* flags;
  int* n_samples;
  long long n_rays;
  cudaStream_t stream;
  int* resident;
};

template <typename T, int INTEGRATOR, int NF, bool TANGENTS>
cudaError_t launch(const LaunchArgs& a) {
  const auto kernel = formula_kernel<T, INTEGRATOR, NF, TANGENTS>;
  if (a.resident) {
    int per_sm = 0, device = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    *a.resident = per_sm * sms;
    return err;
  }
  FormulaLaunchConsts<T, NF> consts;
  if (a.consts_bytes != static_cast<long long>(sizeof(consts)) || a.grid < 1) {
    return cudaErrorInvalidValue;
  }
  memcpy(&consts, a.consts, sizeof(consts));
  kernel<<<static_cast<unsigned>(a.grid), THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.positions), static_cast<const T*>(a.directions),
      static_cast<const T*>(a.momentum_factors), consts, static_cast<const T*>(a.theta),
      a.nf, a.diff_mask, a.ld, a.next_slot, static_cast<T*>(a.i_nu),
      static_cast<T*>(a.d_i_nu), a.flags, a.n_samples, a.n_rays);
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
