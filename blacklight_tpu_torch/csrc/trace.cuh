// The per-ray geodesic loop shared by the fused kernels: step, stored
// sample, truncation and termination for one ray per thread, templated on
// the working type T and the integrator.
//
// Follows the step bodies of the TPU kernels (ops/pallas_formula.py dp
// :363-485, rk4/rk2 :487-578; ops/pallas_simulation.py :929-1335). Each
// thread loops over its own step counter n and stops when its ray dies,
// which gives the Pallas block loop's semantics exactly: all rays of a
// block start together there, and a dead ray's outputs never change
// again. A kernel supplies what happens at a stored sample as a functor;
// the plain PyTorch version of the loop is
// blacklight_tpu_torch/ops/geodesic.py trace_reference.
#pragma once

#include "kerr.cuh"

namespace bl {

enum Integrator : int { INTEGRATOR_DP = 0, INTEGRATOR_RK4 = 1, INTEGRATOR_RK2 = 2 };

// Index order of the geodesic block that opens every fused kernel's float64
// parameter vector (ops/geodesic.py GEODESIC_PARAM_NAMES fills it).
enum GeodesicParam : int {
  G_SPIN,
  G_A2,
  G_TWO_SPIN,
  G_TWO_A2,
  G_THREE_A2,
  G_TWO_MASS,
  G_FLAT,
  G_RAY_STEP,
  G_CAMERA_R,
  G_R_TERMINATE,
  G_R_HORIZON,
  G_TOL_ABS,
  G_TOL_REL,
  G_MAX_STEPS,
  G_MAX_RETRIES,
  G_FALLBACK_NAN,
  G_COUNT
};

// A flag stored as 0 / 1 in a parameter vector of doubles, or of values
// already rounded to T (the formula kernel's launch constants).
template <typename T, typename S>
__device__ __forceinline__ bool flag_at(const S* p, int i) {
  return T(p[i]) != T(0);
}

// Geodesic constants of one launch, each rounded once to T: from the
// float64 vector in device memory, or from values the host already
// rounded to T (then T(p[i]) is the value itself).
template <typename T>
struct TraceConsts {
  KerrConsts<T> g;
  T ray_step, camera_r, r_terminate, r_horizon, tol_abs, tol_rel;
  int max_steps, max_retries;
  bool fallback_nan;

  template <typename S>
  __device__ explicit TraceConsts(const S* p) {
    g.spin = T(p[G_SPIN]);
    g.a2 = T(p[G_A2]);
    g.two_spin = T(p[G_TWO_SPIN]);
    g.two_a2 = T(p[G_TWO_A2]);
    g.three_a2 = T(p[G_THREE_A2]);
    g.two_mass = T(p[G_TWO_MASS]);
    g.flat = flag_at<T>(p, G_FLAT);
    ray_step = T(p[G_RAY_STEP]);
    camera_r = T(p[G_CAMERA_R]);
    r_terminate = T(p[G_R_TERMINATE]);
    r_horizon = T(p[G_R_HORIZON]);
    tol_abs = T(p[G_TOL_ABS]);
    tol_rel = T(p[G_TOL_REL]);
    max_steps = static_cast<int>(p[G_MAX_STEPS]);
    max_retries = static_cast<int>(p[G_MAX_RETRIES]);
    fallback_nan = flag_at<T>(p, G_FALLBACK_NAN);
  }
};

// The integrator state of one ray between two steps: the seven dynamical
// components y (x^0..x^3, p_1..p_3; p_0 is conserved), the dp controller
// (h, num_retry, prev_fail) and the bookkeeping of stored samples. A window
// of the polarized kernel replays from a copy of it (polarized_kernel.cuh);
// its plain twin is ops/geodesic.py RayState.
template <typename T>
struct RayState {
  T y[7];
  T h;  // dp only: the next attempt's step size
  T r_mid_prev;
  int n_samp, num_retry;
  bool alive, trunc, flag, prev_fail;
};

// The state at the camera: y from the ray's position and covariant momentum.
template <typename T>
__device__ __forceinline__ void init_ray_state(const TraceConsts<T>& tc, const T* __restrict__ pos,
                                               const T* __restrict__ dir, RayState<T>& s) {
  s.y[0] = pos[0];
  s.y[1] = pos[1];
  s.y[2] = pos[2];
  s.y[3] = pos[3];
  s.y[4] = dir[1];
  s.y[5] = dir[2];
  s.y[6] = dir[3];
  s.h = -tc.ray_step * ks_radius(s.y[1], s.y[2], s.y[3], tc.g);
  s.r_mid_prev = T(0);
  s.n_samp = 0;
  s.num_retry = 0;
  s.alive = true;
  s.trunc = false;
  s.flag = false;
  s.prev_fail = false;
}

// The fixed-step stages (geodesics.cpp:418-795) of one rk4 or rk2 step hs
// from y: the endpoint ye and the sample point ym (rk4: the mean of y and
// ye; rk2, Heun: y + h/2 k1, geodesics.cpp:626-795).
template <typename T, int INTEGRATOR>
__device__ __forceinline__ void rk_stages(const KerrConsts<T>& g, const T (&y)[7], T p0, T hs,
                                          T (&ye)[7], T (&ym)[7]) {
  T q1[7], q2[7];
  geodesic_rhs(y[1], y[2], y[3], p0, y[4], y[5], y[6], g, q1, static_cast<T*>(nullptr));
  if (INTEGRATOR == INTEGRATOR_RK4) {
    T yt[7], q3[7], q4[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) yt[c] = y[c] + (T(0.5) * hs) * q1[c];
    geodesic_rhs(yt[1], yt[2], yt[3], p0, yt[4], yt[5], yt[6], g, q2,
                 static_cast<T*>(nullptr));
#pragma unroll
    for (int c = 0; c < 7; ++c) yt[c] = y[c] + (T(0.5) * hs) * q2[c];
    geodesic_rhs(yt[1], yt[2], yt[3], p0, yt[4], yt[5], yt[6], g, q3,
                 static_cast<T*>(nullptr));
#pragma unroll
    for (int c = 0; c < 7; ++c) yt[c] = y[c] + hs * q3[c];
    geodesic_rhs(yt[1], yt[2], yt[3], p0, yt[4], yt[5], yt[6], g, q4,
                 static_cast<T*>(nullptr));
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      ye[c] = y[c] + hs * (q1[c] * T(1.0 / 6.0) + q2[c] * T(1.0 / 3.0) +
                           q3[c] * T(1.0 / 3.0) + q4[c] * T(1.0 / 6.0));
      ym[c] = T(0.5) * (y[c] + ye[c]);
    }
  } else {
    T yt[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) yt[c] = y[c] + hs * q1[c];
    geodesic_rhs(yt[1], yt[2], yt[3], p0, yt[4], yt[5], yt[6], g, q2,
                 static_cast<T*>(nullptr));
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      ye[c] = y[c] + T(0.5) * hs * (q1[c] + q2[c]);
      ym[c] = y[c] + (T(0.5) * hs) * q1[c];
    }
  }
}

// The dp attempt's step size from the current h and the proper-distance
// rate ds at y, of radius r: at most ray_step r of proper distance.
template <typename T>
__device__ __forceinline__ T dp_step_size(const TraceConsts<T>& tc, const RayState<T>& s, T r,
                                          T ds) {
  const T ds_dlam = m_abs(ds) + T(1e-30);
  const T h_cap = tc.ray_step * r / ds_dlam;
  return -jmin(m_abs(s.h), h_cap);
}

// The dp controller after an attempt hs from y to ye (4th-order
// endpoint y4): the error estimate over the 7 dynamical components (p_0
// error = 0), acceptance, the next attempt's h and the retry count.
template <typename T>
__device__ __forceinline__ void dp_control(const TraceConsts<T>& tc, RayState<T>& s,
                                           const T (&y)[7], const T (&ye)[7], const T (&y4)[7],
                                           T hs, bool& accept, bool& retry_exceeded) {
  T err = T(0);
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    const T ya = jmax(m_abs(y[c]), m_abs(ye[c]));
    const T sc = tc.tol_abs + tc.tol_rel * ya;
    err = jmax(err, m_abs(ye[c] - y4[c]) / sc);
  }
  accept = err <= T(1);
  const T err_safe = jmax(err, T(1e-30));
  const T fac_ideal = T(DP_ERR_FACTOR) * m_pow(err_safe, T(-DP_ERR_POWER));
  const T fac_rej =
      jmax(m_isfinite(err) ? fac_ideal : T(DP_MIN_FACTOR), T(DP_MIN_FACTOR));
  T fac_acc = jmin(jmax(fac_ideal, T(DP_MIN_FACTOR)), T(DP_MAX_FACTOR));
  if (err == T(0)) fac_acc = T(DP_MAX_FACTOR);
  if (s.prev_fail) fac_acc = jmin(fac_acc, T(1));
  s.h = hs * (accept ? fac_acc : fac_rej);
  s.num_retry = accept ? 0 : s.num_retry + 1;
  retry_exceeded = s.num_retry > tc.max_retries;
  s.flag = s.flag || retry_exceeded;
  s.prev_fail = !accept;
}

// The end of step n from y (radius r) to the endpoint ye (radius r_new,
// null-renormalization factor fac) with sample point ym (radius r_mid,
// factor facm): truncation, termination, the flag, the stored sample's
// momentum k1..k3 and the accepted endpoint. Returns whether the step
// stored a sample that counts.
template <typename T>
__device__ __forceinline__ bool end_step(const TraceConsts<T>& tc, RayState<T>& s, int n,
                                         bool accept, bool retry_exceeded, T r, T r_new,
                                         T r_mid, T fac, T facm, const T (&ye)[7],
                                         const T (&ym)[7], T& k1, T& k2, T& k3) {
  T(&y)[7] = s.y;
  const bool trunc_now =
      s.n_samp > 0 &&
      ((r_mid > tc.camera_r && r_mid > s.r_mid_prev) || r_mid < tc.r_terminate);
  s.trunc = s.trunc || (accept && trunc_now);
  const bool valid = accept && !s.trunc && !retry_exceeded;
  const bool terminate = (r_new > tc.camera_r && r_new > r) || r_new < tc.r_terminate;
  s.flag = s.flag || (accept && !terminate && n == tc.max_steps - 1);
  s.alive = !(accept && terminate) && !retry_exceeded;

  if (valid) {
    k1 = ym[4] * facm;
    k2 = ym[5] * facm;
    k3 = ym[6] * facm;
    s.r_mid_prev = r_mid;
    ++s.n_samp;
  }
  if (s.alive && accept) {
    y[0] = ye[0];
    y[1] = ye[1];
    y[2] = ye[2];
    y[3] = ye[3];
    y[4] = ye[4] * fac;
    y[5] = ye[5] * fac;
    y[6] = ye[6] * fac;
  }
  return valid;
}

// Advance a live ray by step index n (< max_steps). Returns whether the step
// stored a sample that counts, and then sets ym (the sample position
// x^0..x^3), k1..k3 (its null-renormalized covariant spatial momentum; k_0
// = p0), hs (the signed affine step) and qm (the radius parts at ym, which
// the sample's coordinates reuse). A ray that terminates, or runs out of
// dp retries, leaves s.alive false and its y as it was.
template <typename T, int INTEGRATOR>
__device__ __forceinline__ bool step_ray(const TraceConsts<T>& tc, RayState<T>& s, T p0, int n,
                                         T (&ym)[7], T& k1, T& k2, T& k3, T& hs,
                                         KsRadius<T>& qm) {
  const KerrConsts<T>& g = tc.g;
  T(&y)[7] = s.y;
  const T r = ks_radius(y[1], y[2], y[3], g);
  T ye[7];  // step endpoint
  bool accept = true, retry_exceeded = false;

  if (INTEGRATOR == INTEGRATOR_DP) {
    T k[7][7], y4[7], ds;
    geodesic_rhs(y[1], y[2], y[3], p0, y[4], y[5], y[6], g, k[0], &ds);
    hs = dp_step_size(tc, s, r, ds);
    dp_stages(y, p0, hs, g, k, ye, y4, ym);
    dp_control(tc, s, y, ye, y4, hs, accept, retry_exceeded);
  } else {
    // fixed step h = -ray_step (r - r_horizon) (geodesics.cpp:418-795)
    hs = -tc.ray_step * (r - tc.r_horizon);
    rk_stages<T, INTEGRATOR>(g, y, p0, hs, ye, ym);
  }

  // accepted endpoint and stored sample, null-renormalized
  const T fac = renormalize_factor(ye[1], ye[2], ye[3], p0, ye[4], ye[5], ye[6], g);
  const T r_new = ks_radius(ye[1], ye[2], ye[3], g);
  qm = ks_radius_parts(ym[1], ym[2], ym[3], g);
  const T facm = renormalize_factor_at(ym[1], ym[2], ym[3], qm, p0, ym[4], ym[5], ym[6], g);
  return end_step(tc, s, n, accept, retry_exceeded, r, r_new, qm.r, fac, facm, ye, ym, k1,
                  k2, k3);
}

// Advance one ray by the steps n in [n_begin, min(n_end, max_steps)) while
// it is alive, and call on_sample(ym, k1, k2, k3, h, qm) at every stored
// sample that counts, in step order (step_ray): one phase of phased dispatch
// (simulation_kernel.cuh simulation_phase_kernel), or with [0, max_steps)
// the whole trace. Its plain twin is ops/geodesic.py trace_steps.
template <typename T, int INTEGRATOR, typename OnSample>
__device__ __forceinline__ void trace_steps(const TraceConsts<T>& tc, RayState<T>& s, T p0,
                                            int n_begin, int n_end, OnSample& on_sample) {
  const int n_stop = n_end < tc.max_steps ? n_end : tc.max_steps;
  for (int n = n_begin; n < n_stop && s.alive; ++n) {
    T ym[7], k1, k2, k3, hs;
    KsRadius<T> qm;
    if (step_ray<T, INTEGRATOR>(tc, s, p0, n, ym, k1, k2, k3, hs, qm)) {
      on_sample(ym, k1, k2, k3, hs, qm);
    }
  }
}

// Integrate one ray from y (x^0..x^3, p_1..p_3; p_0 is conserved) over
// [0, max_steps) (trace_steps). Returns the ray's flag (it hit max_steps,
// or dp ran out of retries) and its count of samples.
template <typename T, int INTEGRATOR, typename OnSample>
__device__ __forceinline__ void trace_ray(const TraceConsts<T>& tc, RayState<T>& s, T p0,
                                          OnSample& on_sample, bool& flag_out,
                                          int& n_samples_out) {
  trace_steps<T, INTEGRATOR>(tc, s, p0, 0, tc.max_steps, on_sample);
  flag_out = s.flag;
  n_samples_out = s.n_samp;
}

}  // namespace bl
