// Fused simulation-model ray tracer for NVIDIA Hopper (sm_90a): geodesic
// step, GRMHD grid sampling, thermal synchrotron coefficients and
// unpolarized transfer for one ray per thread.
//
// Replaces the TPU kernel blacklight_tpu/ops/pallas_simulation.py
// _make_kernel (:795, launched by render_simulation :1400; K2.1 rk4/rk2,
// K2.2 dp) for a single-block SKS grid, thermal ti_te_beta electrons and
// up to MAX_FREQUENCIES frequencies. Its values follow the JAX package's
// exact (XLA) path in each type's forms: grid/sampling.py sample_grid,
// models/cuts.py geometric_keep, models/synchrotron.py fluid_state,
// value_cuts, pitch_angle and thermal_coefficients, and the update of
// transfer/unpolarized.py integrate_unpolarized. The plain PyTorch version
// is blacklight_tpu_torch/ops/simulation_kernel.py
// render_simulation_reference; this file writes its operation forms
// (a scalar numerator s / t as (1 / t) * s, as PyTorch evaluates it).
//
// The step loop is trace.cuh's trace_ray. At each stored sample the
// SimSample functor converts CKS to SKS with the native atan2/acos, applies
// the geometric cuts, locates the cell on each axis by binary search over
// the face coordinates (the count of faces below the coordinate, which the
// JAX package takes by comparison count), blends the 8 corner cells'
// primitives from a float32 table in global memory read through the
// read-only cache, builds the fluid state, the pitch angle and j/alpha per
// frequency, and updates the per-frequency intensity and optical depth.
// A sample whose coefficients are zero (cut, off the grid, zero field)
// leaves intensity and optical depth unchanged, so those return early;
// an off-grid sample only marks its pixel bad under fallback_nan.
//
// What bounds it on this card: ALU work and latency of the geodesic step
// (the same as the formula kernel) plus the sample's transcendentals, and
// the grid reads. A sample reads 8 cells x 32 bytes = 256 bytes; a
// 1024^2 image of ~1,000 samples per ray reads ~270 GB through the caches,
// but neighbouring rays read neighbouring cells, so L1/L2 absorb most of
// it. No brick, window or overflow latch: those exist in the TPU kernel
// only because of Mosaic's DMA and VMEM rules, and no ray is re-rendered on
// the host. Later work may stage cells in shared memory or order rays by
// image tile.
//
// The instantiations live in two translation units that nvcc builds side
// by side, both without multiply-add contraction (ops/_build.py), so that
// each operation rounds as the plain version's does:
// simulation_kernel.cu holds rk4 and rk2, simulation_kernel_dp.cu dp.
#pragma once

#include <cuda_runtime.h>

#include "cuts.cuh"
#include "simulation_params.cuh"
#include "trace.cuh"

namespace bl {

static_assert(S_FALLBACK_NAN == G_FALLBACK_NAN && S_CUT_NEAR == G_COUNT,
              "the simulation parameters open with the geodesic block");
static_assert(S_PLANE_NZ - S_CUT_NEAR == C_PLANE_NZ,
              "the simulation parameters hold the cut block in cuts.cuh order");

constexpr int SIM_THREADS = 128;
constexpr int MAX_FREQUENCIES = 16;  // the bad-sample mask is 32 bits
constexpr double SIM_DELTA_TAU_MAX = 100.0;  // unpolarized.cpp:96-110
constexpr double TWO_PI = 6.283185307179586;

// Floors and caps that depend on the working type (models/synchrotron.py
// :147-179, :254-268, :819-867): float64 keeps the reference's literal
// forms, float32 the ones that keep single precision finite.
template <typename T>
struct TypeForms;
template <>
struct TypeForms<float> {
  static constexpr bool F64 = false;
  static __device__ __forceinline__ float div_floor() { return 1e-15f; }
  static __device__ __forceinline__ float pitch_floor() { return 1e-16f; }
  static __device__ __forceinline__ float sqrt_cut() { return 1e-24f; }
  static __device__ __forceinline__ float nu_s_floor() { return 1e-12f; }
};
template <>
struct TypeForms<double> {
  static constexpr bool F64 = true;
  static __device__ __forceinline__ double div_floor() { return 1e-30; }
  static __device__ __forceinline__ double pitch_floor() { return 1e-300; }
  static __device__ __forceinline__ double sqrt_cut() { return 1e-300; }
  static __device__ __forceinline__ double nu_s_floor() { return 1e-300; }
};

// Constants of one launch, each rounded once to T.
template <typename T>
struct SimConsts {
  CutConsts<T> cuts;
  T spin, a2, two_spin, camera_r, cam1, cam2, cam3, x_unit;
  bool fallback_nan, use_p;
  T d_unit, e_unit, b_unit, mu_mp, ne_div, rat_high, rat_low, kb_tot;
  T one_plus_ne_ni, ne_ni, gamma_m1, gamma_i_m1, ne_ni_over_gamma_e_m1, me_c2;
  T thermal_frac, e_charge, nu_c_div, two_ninths, var_a, var_b, h_planck, nu0,
      kirchhoff;
  const double* value_cuts;  // S_RHO_MIN..S_BETA_INV_MAX as float64

  __device__ explicit SimConsts(const double* p) : cuts(p + S_CUT_NEAR) {
    spin = T(p[S_SPIN]);
    a2 = T(p[S_A2]);
    two_spin = T(p[S_TWO_SPIN]);
    camera_r = T(p[S_CAMERA_R]);
    cam1 = T(p[S_CAM_X1]);
    cam2 = T(p[S_CAM_X2]);
    cam3 = T(p[S_CAM_X3]);
    x_unit = T(p[S_X_UNIT]);
    fallback_nan = flag_at<T>(p, S_FALLBACK_NAN);
    use_p = flag_at<T>(p, S_USE_P);
    d_unit = T(p[S_D_UNIT]);
    e_unit = T(p[S_E_UNIT]);
    b_unit = T(p[S_B_UNIT]);
    mu_mp = T(p[S_MU_MP]);
    ne_div = T(p[S_NE_DIV]);
    rat_high = T(p[S_RAT_HIGH]);
    rat_low = T(p[S_RAT_LOW]);
    kb_tot = T(p[S_KB_TOT]);
    one_plus_ne_ni = T(p[S_ONE_PLUS_NE_NI]);
    ne_ni = T(p[S_NE_NI]);
    gamma_m1 = T(p[S_GAMMA_M1]);
    gamma_i_m1 = T(p[S_GAMMA_I_M1]);
    ne_ni_over_gamma_e_m1 = T(p[S_NE_NI_OVER_GAMMA_E_M1]);
    me_c2 = T(p[S_ME_C2]);
    thermal_frac = T(p[S_THERMAL_FRAC]);
    e_charge = T(p[S_E_CHARGE]);
    nu_c_div = T(p[S_NU_C_DIV]);
    two_ninths = T(p[S_TWO_NINTHS]);
    var_a = T(p[S_VAR_A]);
    var_b = T(p[S_VAR_B]);
    h_planck = T(p[S_H_PLANCK]);
    nu0 = T(p[S_NU0]);
    kirchhoff = T(p[S_KIRCHHOFF]);
    value_cuts = p + S_RHO_MIN;
  }
};

// The kernel's view of the snapshot: a (n_k, n_j, n_i, 8) float32 table
// (rho, pgas, uu1..3, bb1..3 of a cell side by side, two 16-byte loads) and
// the face and centre coordinates of each axis in T.
template <typename T>
struct GridView {
  const float4* __restrict__ table;
  const T* __restrict__ x1f;
  const T* __restrict__ x1v;
  const T* __restrict__ x2f;
  const T* __restrict__ x2v;
  const T* __restrict__ x3f;
  const T* __restrict__ x3v;
  int n_i, n_j, n_k;
};

// Cell location along one axis (grid/sampling.py _locate :54-87): i is the
// count of faces below x, less one, clamped to the cells; the anchor i_m
// backs off by one when x lies before the centre of cell i (except at the
// block edges), and the fraction f may leave [0, 1] near the edges.
template <typename T>
__device__ __forceinline__ void locate(const T* __restrict__ xf, const T* __restrict__ xv,
                                       int n, T x, int& i_m, T& f) {
  int lo = 0, hi = n + 1;  // faces are non-decreasing (checked on the host)
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(xf + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int i = min(max(lo - 1, 0), n - 1);
  const T xv_i = __ldg(xv + i);
  const bool use_i = (i == 0) || (i != n - 1 && x >= xv_i);
  i_m = use_i ? i : i - 1;
  // n >= 2, so cell i + 1 exists when use_i and cell i - 1 when not
  const T x_lo = use_i ? xv_i : __ldg(xv + i - 1);
  const T x_hi = use_i ? __ldg(xv + i + 1) : xv_i;
  f = (x - x_lo) / (x_hi - x_lo);
}

__device__ __forceinline__ float prim_at(const float4& a, const float4& b, int v) {
  switch (v) {
    case 0: return a.x;
    case 1: return a.y;
    case 2: return a.z;
    case 3: return a.w;
    case 4: return b.x;
    case 5: return b.y;
    case 6: return b.z;
    default: return b.w;
  }
}

// Accumulators of one ray and what happens at each of its stored samples.
template <typename T, int NF>
struct SimSample {
  const SimConsts<T>& c;
  const GridView<T>& grid;
  const T* __restrict__ freqs;  // nus[0..nf), then the image scales
  int nf;
  T p0, mom;
  T intensity[NF];
  T tau[NF];
  unsigned bad;  // bit f: frequency f met a sample the reference would NaN

  __device__ SimSample(const SimConsts<T>& c_, const GridView<T>& grid_,
                       const T* __restrict__ freqs_, int nf_, T p0_, T mom_)
      : c(c_), grid(grid_), freqs(freqs_), nf(nf_), p0(p0_), mom(mom_), bad(0u) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      intensity[f] = T(0);
      tau[f] = T(0);
    }
  }

  __device__ __forceinline__ int n_freq() const { return NF == 1 ? 1 : nf; }

  __device__ __forceinline__ void operator()(const T (&ym)[7], T k1, T k2, T k3, T h) {
    using Forms = TypeForms<T>;
    const T x = ym[1], y = ym[2], z = ym[3];
    const T spin = c.spin;

    // CKS -> SKS (ops/sks.py cks_to_sks); phi in [0, 2 pi)
    const T rr2 = x * x + y * y + z * z;
    const T r2 = T(0.5) * (rr2 - c.a2 + m_hypot(rr2 - c.a2, c.two_spin * z));
    const T r = m_sqrt(r2);
    const T th = m_acos(jmin(jmax(z / r, T(-1)), T(1)));
    const T ph_raw = m_atan2(y, x) - m_atan((T(1) / r) * spin);
    T ph = ph_raw < T(0) ? ph_raw + T(TWO_PI) : ph_raw;
    ph = ph >= T(TWO_PI) ? ph - T(TWO_PI) : ph;

    if (!geometric_keep(c.cuts, x, y, z, r, c.camera_r, c.cam1, c.cam2, c.cam3)) return;

    const int n_i = grid.n_i, n_j = grid.n_j, n_k = grid.n_k;
    const bool off_grid = r < __ldg(grid.x1f) || r > __ldg(grid.x1f + n_i) ||
                          th < __ldg(grid.x2f) || th > __ldg(grid.x2f + n_j) ||
                          ph < __ldg(grid.x3f) || ph > __ldg(grid.x3f + n_k);
    if (off_grid) {
      // fallback values with zero field: zero coefficients, and NaN pixels
      // under fallback_nan
      if (c.fallback_nan) bad = ~0u;
      return;
    }

    // trilinear blend of the 8 corner cells (grid/sampling.py :284-371)
    int i_m, j_m, k_m;
    T f_i, f_j, f_k;
    locate(grid.x1f, grid.x1v, n_i, r, i_m, f_i);
    locate(grid.x2f, grid.x2v, n_j, th, j_m, f_j);
    locate(grid.x3f, grid.x3v, n_k, ph, k_m, f_k);
    i_m = min(max(i_m, 0), n_i - 2);
    j_m = min(max(j_m, 0), n_j - 2);
    k_m = min(max(k_m, 0), n_k - 2);
    const T w[8] = {(T(1) - f_k) * (T(1) - f_j) * (T(1) - f_i),
                    (T(1) - f_k) * (T(1) - f_j) * f_i,
                    (T(1) - f_k) * f_j * (T(1) - f_i),
                    (T(1) - f_k) * f_j * f_i,
                    f_k * (T(1) - f_j) * (T(1) - f_i),
                    f_k * (T(1) - f_j) * f_i,
                    f_k * f_j * (T(1) - f_i),
                    f_k * f_j * f_i};
    const long long anchor =
        (static_cast<long long>(k_m) * n_j + j_m) * static_cast<long long>(n_i) + i_m;
    T v[8];
    float anchor_rho = 0.0f, anchor_pgas = 0.0f;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const int dk = corner >> 2, dj = (corner >> 1) & 1, di = corner & 1;
      const long long cell =
          anchor + (static_cast<long long>(dk) * n_j + dj) * static_cast<long long>(n_i) + di;
      const float4 a = __ldg(grid.table + 2 * cell);
      const float4 b = __ldg(grid.table + 2 * cell + 1);
      if (corner == 0) {
        anchor_rho = a.x;
        anchor_pgas = a.y;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const T term = w[corner] * T(prim_at(a, b, q));
        v[q] = corner == 0 ? term : v[q] + term;
      }
    }
    // positivity repair against the anchor cell (:225-226), then the
    // reference's float32 storage of samples (:189)
    if (v[0] <= T(0)) v[0] = T(anchor_rho);
    if (v[1] <= T(0)) v[1] = T(anchor_pgas);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = T(static_cast<float>(v[q]));
    const T rho = v[0], pgas = v[1], uu1 = v[2], uu2 = v[3], uu3 = v[4];
    const T bb1 = v[5], bb2 = v[6], bb3 = v[7];
    if (bb1 == T(0) && bb2 == T(0) && bb3 == T(0)) return;  // zero field

    // fluid state in SKS (models/synchrotron.py fluid_state, ops/sks.py)
    const T rho_cgs = rho * c.d_unit;
    const T pgas_cgs = pgas * c.e_unit;
    const T n_e_cgs = (rho_cgs / c.mu_mp) / c.ne_div;
    const T cth = z / r;
    const T cth2 = cth * cth;
    const T sth2 = T(1) - cth2;
    const T sigma_m = r2 + c.a2 * cth2;
    const T w_m = T(2) * r / sigma_m;
    const T g_tt = -(T(1) - w_m);
    const T g_tr = w_m;
    const T g_tph = -w_m * spin * sth2;
    const T g_rr = T(1) + w_m;
    const T g_rph = -(T(1) + w_m) * spin * sth2;
    const T g_thth = sigma_m;
    const T g_phph = (r2 + c.a2 + w_m * c.a2 * sth2) * sth2;
    const T gi_tt = -(T(1) + w_m);
    const T gi_tr = w_m;
    const T gi_rph = (T(1) / sigma_m) * spin;

    const T uu0 = m_sqrt(T(1) + g_rr * uu1 * uu1 + T(2) * g_rph * uu1 * uu3 +
                         g_thth * uu2 * uu2 + g_phph * uu3 * uu3);
    const T lapse = T(1) / m_sqrt(-gi_tt);
    const T shift1 = -gi_tr / gi_tt;
    const T shift3 = -gi_rph / gi_tt;
    const T ut = uu0 / lapse;
    const T ur = uu1 - shift1 * uu0 / lapse;
    const T uth = uu2;
    const T uph = uu3 - shift3 * uu0 / lapse;
    const T ucov_r = g_tr * ut + g_rr * ur + g_rph * uph;
    const T ucov_th = g_thth * uth;
    const T ucov_ph = g_tph * ut + g_rph * ur + g_phph * uph;
    const T bt = ucov_r * bb1 + ucov_th * bb2 + ucov_ph * bb3;
    const T br = (bb1 + bt * ur) / ut;
    const T bth = (bb2 + bt * uth) / ut;
    const T bph = (bb3 + bt * uph) / ut;
    const T bcov_t = g_tt * bt + g_tr * br + g_tph * bph;
    const T bcov_r = g_tr * bt + g_rr * br + g_rph * bph;
    const T bcov_th = g_thth * bth;
    const T bcov_ph = g_tph * bt + g_rph * br + g_phph * bph;
    const T b_sq = bcov_t * bt + bcov_r * br + bcov_th * bth + bcov_ph * bph;

    T bb_cgs;
    if (Forms::F64) {
      bb_cgs = (b_sq > T(0) ? m_sqrt(b_sq) : T(0)) * c.b_unit;
    } else {
      bb_cgs = m_sqrt(jmax(b_sq, T(1e-30))) * c.b_unit;
    }
    const T sigma = b_sq / jmax(rho, Forms::div_floor());
    const T beta_inv = b_sq / jmax(T(2) * pgas, Forms::div_floor());
    const T u_b = T(1) / (T(1) + beta_inv * beta_inv);
    const T tti_tte = c.rat_high * u_b + c.rat_low * (T(1) - u_b);
    const T kb_tt_tot = c.kb_tot * (pgas / jmax(rho, Forms::div_floor()));
    T kb_tt_e;
    if (c.use_p) {
      kb_tt_e = (T(1) / (tti_tte + c.ne_ni)) * c.one_plus_ne_ni * kb_tt_tot;
    } else {
      kb_tt_e = c.one_plus_ne_ni * kb_tt_tot / c.gamma_m1;
      kb_tt_e = kb_tt_e / (tti_tte / c.gamma_i_m1 + c.ne_ni_over_gamma_e_m1);
    }
    const T theta_e = kb_tt_e / c.me_c2;

    // value cuts (models/synchrotron.py value_cuts); the on/off test is
    // on the float64 value, as the JAX package tests the Python float
    const T cut_values[7] = {rho_cgs, n_e_cgs, pgas_cgs, theta_e, bb_cgs, sigma, beta_inv};
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const double lo = c.value_cuts[2 * q], hi = c.value_cuts[2 * q + 1];
      if (lo >= 0.0 && cut_values[q] < T(lo)) return;
      if (hi >= 0.0 && cut_values[q] > T(hi)) return;
    }

    // u and b to CKS (ops/sks.py sks_to_cks_vector)
    const T sth = m_sqrt(jmax(T(1) - cth * cth, T(0)));
    const T sph = m_sin(ph_raw), cph = m_cos(ph_raw);
    const T e_r[3] = {sth * cph, sth * sph, cth};
    const T e_th[3] = {cth * (r * cph - spin * sph), cth * (r * sph + spin * cph), -r * sth};
    const T e_ph[3] = {sth * (-r * sph - spin * cph), sth * (r * cph - spin * sph), T(0)};
    const T ux = e_r[0] * ur + e_th[0] * uth + e_ph[0] * uph;
    const T uy = e_r[1] * ur + e_th[1] * uth + e_ph[1] * uph;
    const T uz = e_r[2] * ur - r * sth * uth;
    const T bx = e_r[0] * br + e_th[0] * bth + e_ph[0] * bph;
    const T by = e_r[1] * br + e_th[1] * bth + e_ph[1] * bph;
    const T bz = e_r[2] * br - r * sth * bth;

    // pitch angle from invariants (models/synchrotron.py pitch_angle)
    const T u_dot_k = ut * p0 + ux * k1 + uy * k2 + uz * k3;
    const T b_dot_k = bt * p0 + bx * k1 + by * k2 + bz * k3;
    const T denom = u_dot_k * u_dot_k * jmax(b_sq, Forms::pitch_floor());
    const T cos2 = jmin(b_dot_k * b_dot_k / denom, T(1));
    const T sin2 = T(1) - cos2;
    const T sin_b = sin2 > Forms::sqrt_cut() ? m_sqrt(sin2) : T(0);

    // thermal j_I and alpha_I per frequency, and the transfer update
    const T nu_c = c.e_charge * bb_cgs / c.nu_c_div;
    T nu_s = c.two_ninths * nu_c * (theta_e * theta_e) * sin_b;
    nu_s = jmax(nu_s, Forms::nu_s_floor());
    const T dl_lam = (-h) * c.x_unit;
#pragma unroll 1
    for (int f = 0; f < n_freq(); ++f) {
      const T nu = __ldg(freqs + f);
      const T nu_cgs = -u_dot_k * nu * mom;
      T xx = nu_cgs / nu_s;
      if (!Forms::F64) xx = jmin(xx, T(1e20));
      const T xx_1_3 = m_copysign(m_pow(m_abs(xx), T(1.0 / 3.0)), xx);
      const T xx_1_2 = m_sqrt(xx);
      const T xx_1_6 = m_sqrt(xx_1_3);
      const T ratio = (T(1) / nu_cgs) * c.nu0;
      const T coefficient =
          c.thermal_frac * n_e_cgs * nu_c * (ratio * ratio) * m_exp(-xx_1_3);
      const T var_a = c.var_a * sin_b;
      const T var_c = xx_1_2 + c.var_b * xx_1_6;
      T j = coefficient * var_a * var_c * var_c;
      T hnu_kt;
      if (Forms::F64) {
        hnu_kt = c.h_planck * nu_cgs / kb_tt_e;
      } else {
        hnu_kt = jmin(c.h_planck * nu_cgs / jmax(kb_tt_e, T(1e-18)), T(87));
      }
      T alpha = j * (m_expm1(hnu_kt) * c.kirchhoff);
      if (m_isinf((T(1) / (alpha * alpha)))) alpha = T(0);  // overflow trap
      if (!(m_isfinite(j) && m_isfinite(alpha))) {
        bad |= 1u << f;
        j = T(0);
        alpha = T(0);
      }

      const T dl_cgs = dl_lam / (nu * mom);
      const bool pos_alpha = alpha > T(0);
      const T ss = j / (pos_alpha ? alpha : T(1));
      const T delta_tau = alpha * dl_cgs;
      const T atten = m_exp(-tau[f]);
      const bool thin = delta_tau <= T(SIM_DELTA_TAU_MAX);
      const T contrib = pos_alpha ? (thin ? ss * -m_expm1(-delta_tau) : ss) : j * dl_cgs;
      intensity[f] = intensity[f] + contrib * atten;
      tau[f] = tau[f] + (pos_alpha ? (thin ? delta_tau : T(INFINITY)) : T(0));
    }
  }
};

template <typename T, int INTEGRATOR, int NF>
__global__ void __launch_bounds__(SIM_THREADS)
    simulation_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                      const T* __restrict__ momentum_factors, const T* __restrict__ freqs,
                      int nf, const double* __restrict__ params, GridView<T> grid,
                      T* __restrict__ i_nu, int* __restrict__ flags_out,
                      int* __restrict__ n_samples_out, long long n_rays) {
  const long long ray = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  const TraceConsts<T> tc(params);
  const SimConsts<T> sc(params);

  T y[7];
  y[0] = positions[4 * ray + 0];
  y[1] = positions[4 * ray + 1];
  y[2] = positions[4 * ray + 2];
  y[3] = positions[4 * ray + 3];
  const T p0 = directions[4 * ray + 0];
  y[4] = directions[4 * ray + 1];
  y[5] = directions[4 * ray + 2];
  y[6] = directions[4 * ray + 3];

  SimSample<T, NF> sample(sc, grid, freqs, nf, p0, momentum_factors[ray]);
  bool flag;
  int n_samp;
  trace_ray<T, INTEGRATOR>(tc, y, p0, sample, flag, n_samp);

#pragma unroll 1
  for (int f = 0; f < sample.n_freq(); ++f) {
    const bool poison = ((sample.bad >> f) & 1u) || (tc.fallback_nan && flag);
    i_nu[ray * nf + f] = poison ? T(NAN) : sample.intensity[f] * __ldg(freqs + nf + f);
  }
  flags_out[ray] = flag ? 1 : 0;
  n_samples_out[ray] = n_samp;
}

// Pointers and sizes of one launch, as the C interface receives them.
struct SimLaunchArgs {
  const void* positions;
  const void* directions;
  const void* momentum_factors;
  const void* freqs;
  int nf;
  const double* params;
  const float* table;
  const void* coords;
  int n_i, n_j, n_k;
  void* i_nu;
  int* flags;
  int* n_samples;
  long long n_rays;
  cudaStream_t stream;
};

template <typename T, int INTEGRATOR, int NF>
cudaError_t launch_simulation(const SimLaunchArgs& a) {
  const T* coords = static_cast<const T*>(a.coords);
  GridView<T> grid;
  grid.table = reinterpret_cast<const float4*>(a.table);
  grid.x1f = coords;
  grid.x1v = grid.x1f + a.n_i + 1;
  grid.x2f = grid.x1v + a.n_i;
  grid.x2v = grid.x2f + a.n_j + 1;
  grid.x3f = grid.x2v + a.n_j;
  grid.x3v = grid.x3f + a.n_k + 1;
  grid.n_i = a.n_i;
  grid.n_j = a.n_j;
  grid.n_k = a.n_k;
  const unsigned blocks = static_cast<unsigned>((a.n_rays + SIM_THREADS - 1) / SIM_THREADS);
  simulation_kernel<T, INTEGRATOR, NF><<<blocks, SIM_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.positions), static_cast<const T*>(a.directions),
      static_cast<const T*>(a.momentum_factors), static_cast<const T*>(a.freqs), a.nf,
      a.params, grid, static_cast<T*>(a.i_nu), a.flags, a.n_samples, a.n_rays);
  return cudaGetLastError();
}

// One frequency keeps its accumulators in registers; 2..MAX_FREQUENCIES
// hold them in a local array.
template <typename T, int INTEGRATOR>
cudaError_t launch_simulation_nf(const SimLaunchArgs& a) {
  if (a.nf == 1) return launch_simulation<T, INTEGRATOR, 1>(a);
  return launch_simulation<T, INTEGRATOR, MAX_FREQUENCIES>(a);
}

// dp in float (dtype_code 0) or double (1); defined in simulation_kernel_dp.cu.
cudaError_t launch_simulation_dp(int dtype_code, const SimLaunchArgs& a);

}  // namespace bl
