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
// frequency (sim_sample.cuh, shared with the polarized kernel), and updates
// the per-frequency intensity and optical depth.
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

#include "sim_sample.cuh"

namespace bl {

static_assert(S_FALLBACK_NAN == G_FALLBACK_NAN && S_CUT_NEAR == G_COUNT,
              "the simulation parameters open with the geodesic block");
static_assert(S_PLANE_NZ - S_CUT_NEAR == C_PLANE_NZ,
              "the simulation parameters hold the cut block in cuts.cuh order");

constexpr int SIM_THREADS = 128;
constexpr int MAX_FREQUENCIES = 16;  // the bad-sample mask is 32 bits
constexpr double SIM_DELTA_TAU_MAX = 100.0;  // unpolarized.cpp:96-110

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
    const SksPoint<T> p = cks_to_sks(c, ym[1], ym[2], ym[3]);
    if (!geometric_keep(c.cuts, p.x, p.y, p.z, p.r, c.camera_r, c.cam1, c.cam2, c.cam3)) return;
    if (is_off_grid(grid, p)) {
      // fallback values with zero field: zero coefficients, and NaN pixels
      // under fallback_nan
      if (c.fallback_nan) bad = ~0u;
      return;
    }
    T v[8];
    sample_cell(grid, p, v);
    if (v[5] == T(0) && v[6] == T(0) && v[7] == T(0)) return;  // zero field
    FluidState<T> st;
    fluid_state(c, p, v, st);
    if (!value_keep(c, st)) return;
    T ucon[4], bcon[4];
    fluid_cks(p, c.spin, st, ucon, bcon);
    const Pitch<T> pa = pitch_angle(p0, k1, k2, k3, ucon, bcon, st.b_sq);
    const T u_dot_k = pa.u_dot_k;
    const T sin_b = safe_sqrt(pa.sin2);

    // thermal j_I and alpha_I per frequency, and the transfer update
    const T nu_c = c.e_charge * st.bb_cgs / c.nu_c_div;
    T nu_s = c.two_ninths * nu_c * (st.theta_e * st.theta_e) * sin_b;
    nu_s = jmax(nu_s, Forms::nu_s_floor());
    const T dl_lam = (-h) * c.x_unit;
#pragma unroll 1
    for (int f = 0; f < n_freq(); ++f) {
      const T nu = __ldg(freqs + f);
      const T nu_cgs = -u_dot_k * nu * mom;
      const ThermalI<T> ti = thermal_i(c, nu_cgs, st.n_e_cgs, nu_c, nu_s, sin_b, st.kb_tt_e);
      T j = ti.j, alpha = ti.alpha;
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

  RayState<T> s;
  init_ray_state(tc, positions + 4 * ray, directions + 4 * ray, s);
  const T p0 = directions[4 * ray + 0];

  SimSample<T, NF> sample(sc, grid, freqs, nf, p0, momentum_factors[ray]);
  bool flag;
  int n_samp;
  trace_ray<T, INTEGRATOR>(tc, s, p0, sample, flag, n_samp);

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
  const GridView<T> grid = make_grid_view<T>(a.table, a.coords, a.n_i, a.n_j, a.n_k);
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
