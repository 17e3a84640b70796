// Fused simulation-model ray tracer for NVIDIA Hopper (sm_90a): geodesic
// step, GRMHD grid sampling, synchrotron coefficients and unpolarized
// transfer for one ray per thread at a time.
//
// Replaces the TPU kernel blacklight_tpu/ops/pallas_simulation.py
// _make_kernel (:795, launched by render_simulation :1400; K2.1 rk4/rk2,
// K2.2 dp) for SKS grids (and, as the JAX package's XLA path does, for
// AthenaK's CKS grids: the mode, phase and mixture kernels in the modes
// SAMPLE_CKS_BLOCKS and SAMPLE_CKS_INTERBLOCK, in the units
// simulation_cks{,_dp}.cu, simulation_mixture_cks.cu and
// simulation_phase{,_mixture}_cks.cu), ti_te_beta electrons (thermal, as
// the TPU kernel, or mixed with power-law and kappa ones, below) and up to
// MAX_FREQUENCIES frequencies. Its values follow the JAX package's
// exact (XLA) path in each type's forms: grid/sampling.py sample_grid,
// models/cuts.py geometric_keep, models/synchrotron.py fluid_state,
// value_cuts, pitch_angle and thermal_coefficients, and the update of
// transfer/unpolarized.py integrate_unpolarized. The plain PyTorch version
// is blacklight_tpu_torch/ops/simulation_kernel.py
// render_simulation_reference; this file writes its operation forms
// (a scalar numerator s / t as (1 / t) * s, as PyTorch evaluates it).
//
// The step loop is trace.cuh's trace_steps. At each stored sample the
// SimSample functor converts CKS to SKS with the native atan2/acos, applies
// the geometric cuts, locates the cell on each axis (the count of faces
// below the coordinate, which the JAX package takes by comparison count),
// blends the 8 corner cells' primitives from a float32 table in global
// memory read through the read-only cache, builds the fluid state, the
// pitch angle and j/alpha per frequency (sim_sample.cuh, shared with the
// polarized kernel), and updates the per-frequency intensity and optical
// depth. A sample whose coefficients are zero (cut, off the grid, zero
// field) leaves intensity and optical depth unchanged, so those return
// early; an off-grid sample only marks its pixel bad under fallback_nan.
//
// What bounds it on this card: issuing the geodesic step's instructions
// (the formula kernel's step) and the sample's transcendentals, and their
// latency at the occupancy the registers allow. A sample reads 8 cells x
// 32 bytes; neighbouring rays read neighbouring cells, so L1/L2 absorb most
// of it. What the design does about it:
// - Launch constants in the constant bank. Every geodesic, cut, fluid,
//   thermal and camera constant, the value cuts (off as -inf / +inf) and
//   the launch's frequencies and image scales arrive rounded to T by the
//   host (SimLaunchConsts, packed by ops/simulation_kernel.py
//   launch_consts) as a kernel parameter passed by value, like the grid's
//   view and its axes' bounds; arithmetic reads them as constant-bank
//   operands, so none holds a register across the step loop and the float
//   kernel converts no float64 value at a sample.
// - The sample's radius from the step: step_ray hands over the parts of
//   r at the sample point, which cks_to_sks would compute again.
// - A cell search that starts near the answer: from the previous sample's
//   face counts, carried in registers (a ray moves about a cell a step),
//   or at a ray's first sample from a guide per axis (uniform bins holding
//   the count of faces below each bin), a walk of a face or two, in place
//   of a binary search of ~9 dependent loads an axis.
// - More warps per SM: SimBlocks blocks of SIM_THREADS per SM
//   (__launch_bounds__), chosen per instantiation on an H100 (PERF.md).
// One thread traces one ray, a block the 128 consecutive rays of the
// caller's order (spatial_order: neighbours, whose samples share cells in
// L1). Warps that fetch the next 32 rays from a counter when done, on a
// grid of resident blocks, ended the blocks' tails but scattered a
// block's warps over the launch order: slower in spatial_order in float32
// and in float64 (PERF.md), so the grid is every block.
// No brick, window or overflow latch: those exist in the TPU kernel only
// because of Mosaic's DMA and VMEM rules, and no ray is re-rendered on the
// host.
//
// The instantiations live in translation units that nvcc builds side by
// side, all without multiply-add contraction (ops/_build.py), so that
// each operation rounds as the plain version's does:
// simulation_kernel.cu holds rk4 and rk2, simulation_kernel_dp.cu dp, and
// simulation_phase.cu the phase kernel of phased dispatch (below), which
// must round as simulation_kernel.cu does to give its image bit for bit;
// the units of many blocks follow them.
//
// The electron population is a compile-time parameter too: POP_THERMAL
// (simulation_kernel, simulation_mode_kernel and the phase kernels, the
// thermal ti_te_beta electrons alone) or POP_MIXTURE (the *_mixture_kernel
// templates: the thermal, power-law and kappa populations summed at each
// sample, sim_sample.cuh mixture_i, with the populations' constants after
// the launch constants, SimMixLaunchConsts). The mixture's
// instantiations live in units of their own (simulation_mixture*.cu,
// simulation_phase_mixture*.cu), so that the thermal units compile to the
// code they compiled to before the mixture existed.
#pragma once

#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "sim_sample.cuh"

namespace bl {

static_assert(S_FALLBACK_NAN == G_FALLBACK_NAN && S_CUT_NEAR == G_COUNT,
              "the simulation parameters open with the geodesic block");
static_assert(S_PLANE_NZ - S_CUT_NEAR == C_PLANE_NZ,
              "the simulation parameters hold the cut block in cuts.cuh order");

constexpr int SIM_THREADS = 128;
constexpr int MAX_FREQUENCIES = 16;  // the bad-sample mask is 32 bits
constexpr double SIM_DELTA_TAU_MAX = 100.0;  // unpolarized.cpp:96-110

// The launch constants, rounded once to T on the host: the SimulationParam
// values (a value cut that is off as -inf, a minimum, or +inf, a maximum),
// then the launch's frequencies and their image scales (zero beyond its
// nf). Passed by value as a kernel parameter, they live in the constant
// bank.
template <typename T, int NF>
struct SimLaunchConsts {
  T v[S_COUNT];
  T nu[NF];
  T scale[NF];
};

// A mixture launch's constants: the above, then the MixtureParam values
// rounded to T (ops/simulation_kernel.py launch_consts with mix).
template <typename T, int NF>
struct SimMixLaunchConsts {
  SimLaunchConsts<T, NF> sim;
  T mix[M_COUNT];
};

// At least SimBlocks blocks of SIM_THREADS per SM (__launch_bounds__), per
// instantiation: the float kernels trade registers, and spills that the L1
// cache holds, for warps that hide the latency of their arithmetic
// (PERF.md: k = 4 to 8 timed in turns at 1024^2 on an H100; rk4 and rk2 at
// one and at 16 frequencies gain up to k = 8, 64 registers, dp is fastest
// at k = 6, 80 registers, and slower beyond as its spills grow; the
// kernels of many mesh blocks are fastest at the same k). The double
// kernels take what they need, ~200-235 registers.
template <typename T, int INTEGRATOR>
constexpr int SimBlocks = sizeof(T) != 4 ? 1 : INTEGRATOR == INTEGRATOR_DP ? 6 : 8;

// The block of the ray's previous sample (-1: none), which only the modes
// of many blocks carry (the CKS modes too): SAMPLE_SINGLE's SimSample keeps
// its layout (SAMPLE_FMKS's, one block, has none either).
struct BlockHint {
  int block = -1;
};
struct NoBlockHint {};

// The mixture's constants and the electron entropy's cell table of a
// code_kappa launch (null otherwise), which only POP_MIXTURE's SimSample
// carries.
template <typename T, int POP>
struct PopulationRef {};
template <typename T>
struct PopulationRef<T, POP_MIXTURE> {
  const MixConsts<T>* mix = nullptr;
  const float* kappa = nullptr;
};

// Accumulators of one ray and what happens at each of its stored samples,
// on a grid sampled in MODE (sim_sample.cuh SAMPLE_*), of the population
// POP (POP_MIXTURE: this->mix points at the launch's MixConsts).
template <typename T, int NF, int MODE = SAMPLE_SINGLE, int POP = POP_THERMAL>
struct SimSample : std::conditional_t<MODE == SAMPLE_SINGLE || MODE == SAMPLE_FMKS, NoBlockHint,
                                      BlockHint>,
                   PopulationRef<T, POP> {
  const SimConsts<T>& c;
  const SampleGrid<T, MODE>& grid;
  const T (&nu)[NF];  // the launch's frequencies
  int nf;
  T p0, mom;
  T intensity[NF];
  T tau[NF];
  unsigned bad;  // bit f: frequency f met a sample the reference would NaN
  int hint[3];   // the face counts of the ray's previous sample (-1: none)

  __device__ SimSample(const SimConsts<T>& c_, const SampleGrid<T, MODE>& grid_,
                       const T (&nu_)[NF], int nf_, T p0_, T mom_)
      : c(c_), grid(grid_), nu(nu_), nf(nf_), p0(p0_), mom(mom_), bad(0u), hint{-1, -1, -1} {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      intensity[f] = T(0);
      tau[f] = T(0);
    }
  }

  __device__ __forceinline__ int n_freq() const { return NF == 1 ? 1 : nf; }

  __device__ __forceinline__ void operator()(const T (&ym)[7], T k1, T k2, T k3, T h,
                                             const KsRadius<T>& q) {
    using Forms = TypeForms<T>;
    const SksPoint<T> p = sample_point<MODE>(c, ym[1], ym[2], ym[3], q);
    if (!geometric_keep(c.cuts, p.x, p.y, p.z, p.r, c.camera_r, c.cam1, c.cam2, c.cam3)) return;
    T v[SampleValues<POP>];
    const float* kappa = nullptr;
    if constexpr (POP == POP_MIXTURE) kappa = this->kappa;
    bool on_grid;
    if constexpr (MODE == SAMPLE_SINGLE) {
      on_grid = !is_off_grid(grid, p);
      if (on_grid) sample_cell(grid, p, v, hint, kappa);
    } else if constexpr (MODE == SAMPLE_FMKS) {
      on_grid = sample_fmks(grid, p, v, hint, kappa);
    } else if constexpr (IsCks<MODE>) {
      on_grid = sample_cks<MODE>(grid, p, v, hint, this->block, kappa);
    } else {
      on_grid = sample_blocks<MODE>(grid, p, v, hint, this->block, kappa);
    }
    if (!on_grid) {
      // fallback values with zero field: zero coefficients, and NaN pixels
      // under fallback_nan
      if (c.fallback_nan) bad = ~0u;
      return;
    }
    if (v[5] == T(0) && v[6] == T(0) && v[7] == T(0)) return;  // zero field
    FluidState<T> st;
    T ucon[4], bcon[4];
    if constexpr (IsCks<MODE>) {
      fluid_state_cks(c, p, v, st, ucon, bcon);
      if constexpr (POP == POP_MIXTURE) code_kappa_state(*this->mix, v[0], v[8], st);
      if (!value_keep(c, st)) return;
    } else {
      fluid_state(c, p, v, st);
      if constexpr (POP == POP_MIXTURE) code_kappa_state(*this->mix, v[0], v[8], st);
      if (!value_keep(c, st)) return;
      fluid_cks(p, c.spin, st, ucon, bcon);
    }
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
      const T nu_f = nu[f];
      const T nu_cgs = -u_dot_k * nu_f * mom;
      const ThermalI<T> ti = thermal_i(c, nu_cgs, st.n_e_cgs, nu_c, nu_s, sin_b, st.kb_tt_e);
      T j = ti.j, alpha = ti.alpha;
      if constexpr (POP == POP_MIXTURE) {
        mixture_i(*this->mix, c, ti, nu_cgs, st.n_e_cgs, nu_c, sin_b, j, alpha);
      }
      if (!(m_isfinite(j) && m_isfinite(alpha))) {
        bad |= 1u << f;
        j = T(0);
        alpha = T(0);
      }

      const T dl_cgs = dl_lam / (nu_f * mom);
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

// The MixConsts of a POP_MIXTURE launch (from its launch constants
// `mix`) and its electron entropy's table; nothing for POP_THERMAL.
template <typename T, int POP>
struct MixHolder {
  __device__ MixHolder(const T*, const float*) {}
  template <typename S>
  __device__ void attach(S&) const {}
};
template <typename T>
struct MixHolder<T, POP_MIXTURE> {
  MixConsts<T> m;
  const float* kappa;
  __device__ MixHolder(const T* mix, const float* kappa_)
      : m(mix, RoundedConsts{}), kappa(kappa_) {}
  template <typename S>
  __device__ void attach(S& sample) const {
    sample.mix = &m;
    sample.kappa = kappa;
  }
};

// One ray of the monolithic kernel; i_nu: (n_rays, nf) row-major. mix:
// POP_MIXTURE's MixtureParam launch constants, kappa its electron
// entropy's table (null where the launch has none).
template <typename T, int INTEGRATOR, int NF, int MODE, int POP = POP_THERMAL>
__device__ __forceinline__ void simulation_ray(long long ray, const T* __restrict__ positions,
                                               const T* __restrict__ directions,
                                               const T* __restrict__ momentum_factors,
                                               const SimLaunchConsts<T, NF>& consts, int nf,
                                               const SampleGrid<T, MODE>& grid,
                                               T* __restrict__ i_nu, int* __restrict__ flags_out,
                                               int* __restrict__ n_samples_out,
                                               const T* mix = nullptr,
                                               const float* kappa = nullptr) {
  const TraceConsts<T> tc(consts.v);
  const SimConsts<T> sc(consts.v, RoundedConsts{});
  const MixHolder<T, POP> mc(mix, kappa);

  RayState<T> s;
  init_ray_state(tc, positions + 4 * ray, directions + 4 * ray, s);
  const T p0 = directions[4 * ray + 0];
  SimSample<T, NF, MODE, POP> sample(sc, grid, consts.nu, nf, p0, momentum_factors[ray]);
  mc.attach(sample);
  trace_steps<T, INTEGRATOR>(tc, s, p0, 0, tc.max_steps, sample);

#pragma unroll 1
  for (int f = 0; f < sample.n_freq(); ++f) {
    const bool poison = ((sample.bad >> f) & 1u) || (tc.fallback_nan && s.flag);
    i_nu[ray * nf + f] = poison ? T(NAN) : sample.intensity[f] * consts.scale[f];
  }
  flags_out[ray] = s.flag ? 1 : 0;
  n_samples_out[ray] = s.n_samp;
}

// One mesh block, trilinear (SAMPLE_SINGLE).
template <typename T, int INTEGRATOR, int NF>
__global__ void __launch_bounds__(SIM_THREADS, SimBlocks<T, INTEGRATOR>)
    simulation_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                      const T* __restrict__ momentum_factors,
                      const __grid_constant__ SimLaunchConsts<T, NF> consts, int nf,
                      const __grid_constant__ GridView<T> grid, T* __restrict__ i_nu,
                      int* __restrict__ flags_out, int* __restrict__ n_samples_out,
                      long long n_rays) {
  const long long ray = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  simulation_ray<T, INTEGRATOR, NF, SAMPLE_SINGLE>(ray, positions, directions, momentum_factors,
                                                   consts, nf, grid, i_nu, flags_out,
                                                   n_samples_out);
}

// Many mesh blocks or the nearest cell (MODE SAMPLE_BLOCKS or
// SAMPLE_INTERBLOCK), instantiated in simulation_blocks.cu and
// simulation_blocks_dp.cu; a CKS grid (SAMPLE_CKS_BLOCKS or
// SAMPLE_CKS_INTERBLOCK) in simulation_cks.cu and simulation_cks_dp.cu.
template <typename T, int INTEGRATOR, int NF, int MODE>
__global__ void __launch_bounds__(SIM_THREADS, SimBlocks<T, INTEGRATOR>)
    simulation_mode_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                           const T* __restrict__ momentum_factors,
                           const __grid_constant__ SimLaunchConsts<T, NF> consts, int nf,
                           const __grid_constant__ BlockGridView<T> grid, T* __restrict__ i_nu,
                           int* __restrict__ flags_out, int* __restrict__ n_samples_out,
                           long long n_rays) {
  const long long ray = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  simulation_ray<T, INTEGRATOR, NF, MODE>(ray, positions, directions, momentum_factors, consts,
                                          nf, grid, i_nu, flags_out, n_samples_out);
}

// One FMKS block (SAMPLE_FMKS), trilinear or at the nearest cell,
// instantiated in simulation_fmks.cu and simulation_fmks_dp.cu.
template <typename T, int INTEGRATOR, int NF>
__global__ void __launch_bounds__(SIM_THREADS, SimBlocks<T, INTEGRATOR>)
    simulation_fmks_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                           const T* __restrict__ momentum_factors,
                           const __grid_constant__ SimLaunchConsts<T, NF> consts, int nf,
                           const __grid_constant__ FmksGridView<T> grid, T* __restrict__ i_nu,
                           int* __restrict__ flags_out, int* __restrict__ n_samples_out,
                           long long n_rays) {
  const long long ray = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  simulation_ray<T, INTEGRATOR, NF, SAMPLE_FMKS>(ray, positions, directions, momentum_factors,
                                                 consts, nf, grid, i_nu, flags_out, n_samples_out);
}

// The thermal, power-law and kappa populations (POP_MIXTURE) on one block
// or many, in any mode, instantiated in simulation_mixture*.cu (SAMPLE_FMKS
// in simulation_mixture_fmks.cu, the CKS modes in
// simulation_mixture_cks.cu); at the code_kappa temperature where the
// launch constants say so, reading the electron entropy from `kappa`
// (n_b, n_k, n_j, n_i) float32, a table beside the 32-byte rows.
template <typename T, int INTEGRATOR, int NF, int MODE>
__global__ void __launch_bounds__(SIM_THREADS, SimBlocks<T, INTEGRATOR>)
    simulation_mixture_kernel(const T* __restrict__ positions, const T* __restrict__ directions,
                              const T* __restrict__ momentum_factors,
                              const __grid_constant__ SimMixLaunchConsts<T, NF> consts, int nf,
                              const __grid_constant__ SampleGrid<T, MODE> grid,
                              const float* __restrict__ kappa, T* __restrict__ i_nu,
                              int* __restrict__ flags_out, int* __restrict__ n_samples_out,
                              long long n_rays) {
  const long long ray = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  simulation_ray<T, INTEGRATOR, NF, MODE, POP_MIXTURE>(ray, positions, directions,
                                                       momentum_factors, consts.sim, nf, grid,
                                                       i_nu, flags_out, n_samples_out,
                                                       consts.mix, kappa);
}

// The launch constants of an instantiation from the host's copy (bytes
// long); false if the size is not the struct's.
template <typename C>
bool copy_consts(const void* host, long long bytes, C& consts) {
  if (bytes != static_cast<long long>(sizeof(consts))) return false;
  memcpy(&consts, host, sizeof(consts));
  return true;
}

// Pointers and sizes of one launch, as the C interface receives them.
// consts: the host's SimLaunchConsts (consts_bytes long).
struct SimLaunchArgs {
  const void* positions;
  const void* directions;
  const void* momentum_factors;
  const void* consts;
  long long consts_bytes;
  int nf;
  SimGridArgs grid;
  void* i_nu;
  int* flags;
  int* n_samples;
  long long n_rays;
  cudaStream_t stream;
};

// MODE SAMPLE_SINGLE launches simulation_kernel, SAMPLE_FMKS
// simulation_fmks_kernel, the others (the CKS modes too)
// simulation_mode_kernel; POP_MIXTURE simulation_mixture_kernel.
template <typename T, int INTEGRATOR, int NF, int MODE, int POP = POP_THERMAL>
cudaError_t launch_simulation(const SimLaunchArgs& a) {
  const unsigned blocks = static_cast<unsigned>((a.n_rays + SIM_THREADS - 1) / SIM_THREADS);
  if constexpr (POP == POP_MIXTURE) {
    SimMixLaunchConsts<T, NF> consts;
    if (!copy_consts(a.consts, a.consts_bytes, consts)) return cudaErrorInvalidValue;
    simulation_mixture_kernel<T, INTEGRATOR, NF, MODE><<<blocks, SIM_THREADS, 0, a.stream>>>(
        static_cast<const T*>(a.positions), static_cast<const T*>(a.directions),
        static_cast<const T*>(a.momentum_factors), consts, a.nf, grid_view_of<T, MODE>(a.grid),
        a.grid.kappa, static_cast<T*>(a.i_nu), a.flags, a.n_samples, a.n_rays);
  } else {
    SimLaunchConsts<T, NF> consts;
    if (!copy_consts(a.consts, a.consts_bytes, consts)) return cudaErrorInvalidValue;
    if constexpr (MODE == SAMPLE_SINGLE) {
      simulation_kernel<T, INTEGRATOR, NF><<<blocks, SIM_THREADS, 0, a.stream>>>(
          static_cast<const T*>(a.positions), static_cast<const T*>(a.directions),
          static_cast<const T*>(a.momentum_factors), consts, a.nf, a.grid.view<T>(),
          static_cast<T*>(a.i_nu), a.flags, a.n_samples, a.n_rays);
    } else if constexpr (MODE == SAMPLE_FMKS) {
      simulation_fmks_kernel<T, INTEGRATOR, NF><<<blocks, SIM_THREADS, 0, a.stream>>>(
          static_cast<const T*>(a.positions), static_cast<const T*>(a.directions),
          static_cast<const T*>(a.momentum_factors), consts, a.nf, a.grid.fmks_view<T>(),
          static_cast<T*>(a.i_nu), a.flags, a.n_samples, a.n_rays);
    } else {
      simulation_mode_kernel<T, INTEGRATOR, NF, MODE><<<blocks, SIM_THREADS, 0, a.stream>>>(
          static_cast<const T*>(a.positions), static_cast<const T*>(a.directions),
          static_cast<const T*>(a.momentum_factors), consts, a.nf, a.grid.block_view<T>(),
          static_cast<T*>(a.i_nu), a.flags, a.n_samples, a.n_rays);
    }
  }
  return cudaGetLastError();
}

// The frequency bucket of a launch of nf frequencies (ops/simulation_kernel.py
// frequency_bucket): one frequency keeps its accumulators in registers,
// 2..MAX_FREQUENCIES hold them in a local array. The mixture's kernels of
// many blocks and its phase kernels are built for MAX_FREQUENCIES alone,
// which takes one frequency too, so that the build stays short.
template <int MODE, int POP>
constexpr bool OneFrequencyBucket = POP == POP_THERMAL || MODE == SAMPLE_SINGLE;

template <typename T, int INTEGRATOR, int MODE = SAMPLE_SINGLE, int POP = POP_THERMAL>
cudaError_t launch_simulation_nf(const SimLaunchArgs& a) {
  if constexpr (OneFrequencyBucket<MODE, POP>) {
    if (a.nf == 1) return launch_simulation<T, INTEGRATOR, 1, MODE, POP>(a);
  }
  return launch_simulation<T, INTEGRATOR, MAX_FREQUENCIES, MODE, POP>(a);
}

// The modes of many blocks (a.grid.mode SAMPLE_BLOCKS or
// SAMPLE_INTERBLOCK): rk4 and rk2 in simulation_blocks.cu, dp in
// simulation_blocks_dp.cu (the mixture's in simulation_mixture_blocks*.cu).
template <int INTEGRATOR, int POP = POP_THERMAL>
cudaError_t launch_simulation_blocks(int dtype_code, const SimLaunchArgs& a) {
  const bool inter = a.grid.mode == SAMPLE_INTERBLOCK;
  if (dtype_code == 0) {
    return inter ? launch_simulation_nf<float, INTEGRATOR, SAMPLE_INTERBLOCK, POP>(a)
                 : launch_simulation_nf<float, INTEGRATOR, SAMPLE_BLOCKS, POP>(a);
  }
  if (dtype_code == 1) {
    return inter ? launch_simulation_nf<double, INTEGRATOR, SAMPLE_INTERBLOCK, POP>(a)
                 : launch_simulation_nf<double, INTEGRATOR, SAMPLE_BLOCKS, POP>(a);
  }
  return cudaErrorInvalidValue;
}

// dp in float (dtype_code 0) or double (1) on one block (defined in
// simulation_kernel_dp.cu); every integrator on many blocks (defined in
// simulation_blocks.cu and simulation_blocks_dp.cu).
cudaError_t launch_simulation_dp(int dtype_code, const SimLaunchArgs& a);
cudaError_t launch_simulation_rk_blocks(int dtype_code, int integrator, const SimLaunchArgs& a);
cudaError_t launch_simulation_dp_blocks(int dtype_code, const SimLaunchArgs& a);
// The mixture (POP_MIXTURE): dp on one block (simulation_mixture_dp.cu),
// rk4 and rk2 on many (simulation_mixture_blocks.cu), dp on many
// (simulation_mixture_blocks_dp.cu).
cudaError_t launch_simulation_mixture_dp(int dtype_code, const SimLaunchArgs& a);
cudaError_t launch_simulation_mixture_rk_blocks(int dtype_code, int integrator,
                                                const SimLaunchArgs& a);
cudaError_t launch_simulation_mixture_dp_blocks(int dtype_code, const SimLaunchArgs& a);
// One FMKS block (a.grid.mode SAMPLE_FMKS): every integrator, rk4 and rk2
// in simulation_fmks.cu and dp in simulation_fmks_dp.cu; the mixture's
// in simulation_mixture_fmks.cu.
cudaError_t launch_simulation_fmks(int dtype_code, int integrator, const SimLaunchArgs& a);
cudaError_t launch_simulation_fmks_dp(int dtype_code, const SimLaunchArgs& a);
cudaError_t launch_simulation_mixture_fmks(int dtype_code, int integrator,
                                           const SimLaunchArgs& a);

// A CKS mode (a.grid.mode SAMPLE_CKS_BLOCKS or SAMPLE_CKS_INTERBLOCK) in
// INTEGRATOR and POP, float (dtype_code 0) or double (1).
template <int INTEGRATOR, int POP = POP_THERMAL>
cudaError_t launch_simulation_cks_modes(int dtype_code, const SimLaunchArgs& a) {
  const bool inter = a.grid.mode == SAMPLE_CKS_INTERBLOCK;
  if (dtype_code == 0) {
    return inter ? launch_simulation_nf<float, INTEGRATOR, SAMPLE_CKS_INTERBLOCK, POP>(a)
                 : launch_simulation_nf<float, INTEGRATOR, SAMPLE_CKS_BLOCKS, POP>(a);
  }
  if (dtype_code == 1) {
    return inter ? launch_simulation_nf<double, INTEGRATOR, SAMPLE_CKS_INTERBLOCK, POP>(a)
                 : launch_simulation_nf<double, INTEGRATOR, SAMPLE_CKS_BLOCKS, POP>(a);
  }
  return cudaErrorInvalidValue;
}

// A CKS grid: every integrator, rk4 and rk2 in simulation_cks.cu and dp in
// simulation_cks_dp.cu; the mixture's in simulation_mixture_cks.cu.
cudaError_t launch_simulation_cks(int dtype_code, int integrator, const SimLaunchArgs& a);
cudaError_t launch_simulation_cks_dp(int dtype_code, const SimLaunchArgs& a);
cudaError_t launch_simulation_mixture_cks(int dtype_code, int integrator,
                                          const SimLaunchArgs& a);

// ---------------------------------------------------------------------------
// Phased dispatch (K2.3): one phase of the kernel above from a carried state.
//
// Replaces the TPU kernel's carry_io mode (blacklight_tpu/ops/
// pallas_simulation.py _make_kernel with carry_io=True, launched by
// render_simulation_phase :1484, driven by render_simulation_phased :1588).
// Each thread takes one ray from an int32 list of live rays, reads its
// RayState and its transfer sums from struct-of-arrays buffers of the whole
// bundle, runs the steps [n_base, n_base + phase_steps) with the same
// step_ray and SimSample as simulation_kernel, and writes them back in
// place. The state stays where it is between phases, so compacting the pool
// moves 4 bytes per survivor (its index), not the state; the wrapper
// (ops/simulation_kernel.py render_simulation_phased) drops finished rays
// from the list and re-orders it between launches. A ray's result is bit
// for bit the monolithic kernel's: the loop is cut at a step boundary and
// every carried value is stored exactly.
//
// What bounds it: the same arithmetic as simulation_kernel, plus per phase
// the carried state (~56 bytes a ray in float at one frequency) read and
// written once. rk4 and rk2 only, as the TPU kernel: dp would also carry
// its step controller. Instantiated in simulation_phase.cu.

// Bits of the carried masks (ops/simulation_kernel.py ALIVE, TRUNC, FLAG).
constexpr int CARRY_ALIVE = 1;
constexpr int CARRY_TRUNC = 2;
constexpr int CARRY_FLAG = 4;

// The carried state of a ray bundle, each plane n_rays long and indexed by
// the ray's place in the bundle (ops/simulation_kernel.py SimCarry). The
// transfer sums and the bad-sample bits are this launch's frequencies'.
template <typename T>
struct SimCarryView {
  T* y;           // [7][n_rays]: x^0..x^3, p_1..p_3
  T* r_mid_prev;  // [n_rays]
  int* n_samp;    // [n_rays]
  int* masks;     // [n_rays]: CARRY_ALIVE | CARRY_TRUNC | CARRY_FLAG
  T* intensity;   // [nf][n_rays]: the unscaled transfer sum
  T* tau;         // [nf][n_rays]: the optical depth
  int* bad;       // [n_rays]: SimSample::bad
  long long n_rays;
};

// One ray of a phase: the ray of the bundle at place `slot` of the list.
template <typename T, int INTEGRATOR, int NF, int MODE, int POP = POP_THERMAL>
__device__ __forceinline__ void simulation_phase_ray(
    long long slot, const int* __restrict__ index, int n_base, int phase_steps, bool write_state,
    const T* __restrict__ directions, const T* __restrict__ momentum_factors,
    const SimLaunchConsts<T, NF>& consts, int nf, const SampleGrid<T, MODE>& grid,
    const SimCarryView<T>& carry, const T* mix = nullptr, const float* kappa = nullptr) {
  const long long ray = index[slot];
  const long long n = carry.n_rays;
  const TraceConsts<T> tc(consts.v);
  const SimConsts<T> sc(consts.v, RoundedConsts{});
  const MixHolder<T, POP> mc(mix, kappa);

  RayState<T> s;
#pragma unroll
  for (int c = 0; c < 7; ++c) s.y[c] = carry.y[c * n + ray];
  s.h = T(0);  // rk4 and rk2 do not read it
  s.r_mid_prev = carry.r_mid_prev[ray];
  s.n_samp = carry.n_samp[ray];
  s.num_retry = 0;
  const int masks = carry.masks[ray];
  s.alive = (masks & CARRY_ALIVE) != 0;
  s.trunc = (masks & CARRY_TRUNC) != 0;
  s.flag = (masks & CARRY_FLAG) != 0;
  s.prev_fail = false;
  const T p0 = directions[4 * ray + 0];

  // the face counts and the block are not carried: a phase starts its
  // search afresh
  SimSample<T, NF, MODE, POP> sample(sc, grid, consts.nu, nf, p0, momentum_factors[ray]);
  mc.attach(sample);
#pragma unroll 1
  for (int f = 0; f < sample.n_freq(); ++f) {
    sample.intensity[f] = carry.intensity[f * n + ray];
    sample.tau[f] = carry.tau[f * n + ray];
  }
  sample.bad = static_cast<unsigned>(carry.bad[ray]);
  trace_steps<T, INTEGRATOR>(tc, s, p0, n_base, n_base + phase_steps, sample);

#pragma unroll 1
  for (int f = 0; f < sample.n_freq(); ++f) {
    carry.intensity[f * n + ray] = sample.intensity[f];
    carry.tau[f * n + ray] = sample.tau[f];
  }
  carry.bad[ray] = static_cast<int>(sample.bad);
  if (!write_state) return;
#pragma unroll
  for (int c = 0; c < 7; ++c) carry.y[c * n + ray] = s.y[c];
  carry.r_mid_prev[ray] = s.r_mid_prev;
  carry.n_samp[ray] = s.n_samp;
  carry.masks[ray] = (s.alive ? CARRY_ALIVE : 0) | (s.trunc ? CARRY_TRUNC : 0) |
                     (s.flag ? CARRY_FLAG : 0);
}

// The phase kernel takes the monolithic kernel's SimBlocks, so that the
// two differ in how they are dispatched, not in occupancy. One mesh block,
// trilinear (SAMPLE_SINGLE).
template <typename T, int INTEGRATOR, int NF>
__global__ void __launch_bounds__(SIM_THREADS, SimBlocks<T, INTEGRATOR>)
    simulation_phase_kernel(const int* __restrict__ index, long long n_live, int n_base,
                            int phase_steps, bool write_state, const T* __restrict__ directions,
                            const T* __restrict__ momentum_factors,
                            const __grid_constant__ SimLaunchConsts<T, NF> consts, int nf,
                            const __grid_constant__ GridView<T> grid, SimCarryView<T> carry) {
  const long long slot = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (slot >= n_live) return;
  simulation_phase_ray<T, INTEGRATOR, NF, SAMPLE_SINGLE>(slot, index, n_base, phase_steps,
                                                         write_state, directions,
                                                         momentum_factors, consts, nf, grid,
                                                         carry);
}

// Many mesh blocks or the nearest cell (MODE SAMPLE_BLOCKS or
// SAMPLE_INTERBLOCK), instantiated in simulation_phase_blocks.cu; a CKS
// grid (SAMPLE_CKS_BLOCKS or SAMPLE_CKS_INTERBLOCK) in
// simulation_phase_cks.cu.
template <typename T, int INTEGRATOR, int NF, int MODE>
__global__ void __launch_bounds__(SIM_THREADS, SimBlocks<T, INTEGRATOR>)
    simulation_phase_mode_kernel(const int* __restrict__ index, long long n_live, int n_base,
                                 int phase_steps, bool write_state,
                                 const T* __restrict__ directions,
                                 const T* __restrict__ momentum_factors,
                                 const __grid_constant__ SimLaunchConsts<T, NF> consts, int nf,
                                 const __grid_constant__ BlockGridView<T> grid,
                                 SimCarryView<T> carry) {
  const long long slot = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (slot >= n_live) return;
  simulation_phase_ray<T, INTEGRATOR, NF, MODE>(slot, index, n_base, phase_steps, write_state,
                                                directions, momentum_factors, consts, nf, grid,
                                                carry);
}

// One FMKS block (SAMPLE_FMKS), instantiated in simulation_phase_fmks.cu.
template <typename T, int INTEGRATOR, int NF>
__global__ void __launch_bounds__(SIM_THREADS, SimBlocks<T, INTEGRATOR>)
    simulation_phase_fmks_kernel(const int* __restrict__ index, long long n_live, int n_base,
                                 int phase_steps, bool write_state,
                                 const T* __restrict__ directions,
                                 const T* __restrict__ momentum_factors,
                                 const __grid_constant__ SimLaunchConsts<T, NF> consts, int nf,
                                 const __grid_constant__ FmksGridView<T> grid,
                                 SimCarryView<T> carry) {
  const long long slot = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (slot >= n_live) return;
  simulation_phase_ray<T, INTEGRATOR, NF, SAMPLE_FMKS>(slot, index, n_base, phase_steps,
                                                       write_state, directions,
                                                       momentum_factors, consts, nf, grid,
                                                       carry);
}

// The mixture (POP_MIXTURE) on one block or many, in any mode,
// instantiated in simulation_phase_mixture*.cu (SAMPLE_FMKS in
// simulation_phase_mixture_fmks.cu, the CKS modes in
// simulation_phase_mixture_cks.cu).
template <typename T, int INTEGRATOR, int NF, int MODE>
__global__ void __launch_bounds__(SIM_THREADS, SimBlocks<T, INTEGRATOR>)
    simulation_phase_mixture_kernel(const int* __restrict__ index, long long n_live, int n_base,
                                    int phase_steps, bool write_state,
                                    const T* __restrict__ directions,
                                    const T* __restrict__ momentum_factors,
                                    const __grid_constant__ SimMixLaunchConsts<T, NF> consts,
                                    int nf, const __grid_constant__ SampleGrid<T, MODE> grid,
                                    const float* __restrict__ kappa, SimCarryView<T> carry) {
  const long long slot = static_cast<long long>(blockIdx.x) * SIM_THREADS + threadIdx.x;
  if (slot >= n_live) return;
  simulation_phase_ray<T, INTEGRATOR, NF, MODE, POP_MIXTURE>(
      slot, index, n_base, phase_steps, write_state, directions, momentum_factors, consts.sim,
      nf, grid, carry, consts.mix, kappa);
}

// Pointers and sizes of one phase launch, as the C interface receives
// them.
struct SimPhaseArgs {
  const int* index;
  long long n_live;
  int n_base, phase_steps;
  bool write_state;
  const void* directions;
  const void* momentum_factors;
  const void* consts;
  long long consts_bytes;
  int nf;
  SimGridArgs grid;
  void* y;
  void* r_mid_prev;
  int* n_samp;
  int* masks;
  void* intensity;
  void* tau;
  int* bad;
  long long n_rays;
  cudaStream_t stream;
};

template <typename T, int INTEGRATOR, int NF, int MODE, int POP = POP_THERMAL>
cudaError_t launch_simulation_phase(const SimPhaseArgs& a) {
  const SimCarryView<T> carry{static_cast<T*>(a.y),         static_cast<T*>(a.r_mid_prev),
                              a.n_samp,                      a.masks,
                              static_cast<T*>(a.intensity), static_cast<T*>(a.tau),
                              a.bad,                         a.n_rays};
  const unsigned blocks = static_cast<unsigned>((a.n_live + SIM_THREADS - 1) / SIM_THREADS);
  if constexpr (POP == POP_MIXTURE) {
    SimMixLaunchConsts<T, NF> consts;
    if (!copy_consts(a.consts, a.consts_bytes, consts)) return cudaErrorInvalidValue;
    simulation_phase_mixture_kernel<T, INTEGRATOR, NF, MODE><<<blocks, SIM_THREADS, 0, a.stream>>>(
        a.index, a.n_live, a.n_base, a.phase_steps, a.write_state,
        static_cast<const T*>(a.directions), static_cast<const T*>(a.momentum_factors), consts,
        a.nf, grid_view_of<T, MODE>(a.grid), a.grid.kappa, carry);
  } else {
    SimLaunchConsts<T, NF> consts;
    if (!copy_consts(a.consts, a.consts_bytes, consts)) return cudaErrorInvalidValue;
    if constexpr (MODE == SAMPLE_SINGLE) {
      simulation_phase_kernel<T, INTEGRATOR, NF><<<blocks, SIM_THREADS, 0, a.stream>>>(
          a.index, a.n_live, a.n_base, a.phase_steps, a.write_state,
          static_cast<const T*>(a.directions), static_cast<const T*>(a.momentum_factors), consts,
          a.nf, a.grid.view<T>(), carry);
    } else if constexpr (MODE == SAMPLE_FMKS) {
      simulation_phase_fmks_kernel<T, INTEGRATOR, NF><<<blocks, SIM_THREADS, 0, a.stream>>>(
          a.index, a.n_live, a.n_base, a.phase_steps, a.write_state,
          static_cast<const T*>(a.directions), static_cast<const T*>(a.momentum_factors), consts,
          a.nf, a.grid.fmks_view<T>(), carry);
    } else {
      simulation_phase_mode_kernel<T, INTEGRATOR, NF, MODE><<<blocks, SIM_THREADS, 0, a.stream>>>(
          a.index, a.n_live, a.n_base, a.phase_steps, a.write_state,
          static_cast<const T*>(a.directions), static_cast<const T*>(a.momentum_factors), consts,
          a.nf, a.grid.block_view<T>(), carry);
    }
  }
  return cudaGetLastError();
}

template <typename T, int INTEGRATOR, int MODE = SAMPLE_SINGLE, int POP = POP_THERMAL>
cudaError_t launch_simulation_phase_nf(const SimPhaseArgs& a) {
  if constexpr (POP == POP_THERMAL) {
    if (a.nf == 1) return launch_simulation_phase<T, INTEGRATOR, 1, MODE, POP>(a);
  }
  return launch_simulation_phase<T, INTEGRATOR, MAX_FREQUENCIES, MODE, POP>(a);
}

// The phase kernel on many blocks (a.grid.mode SAMPLE_BLOCKS or
// SAMPLE_INTERBLOCK); defined in simulation_phase_blocks.cu, the mixture's
// in simulation_phase_mixture_blocks.cu.
cudaError_t launch_simulation_phase_blocks(int dtype_code, int integrator,
                                           const SimPhaseArgs& a);
cudaError_t launch_simulation_phase_mixture_blocks(int dtype_code, int integrator,
                                                   const SimPhaseArgs& a);
// The phase kernel on one FMKS block (SAMPLE_FMKS); defined in
// simulation_phase_fmks.cu, the mixture's in
// simulation_phase_mixture_fmks.cu.
cudaError_t launch_simulation_phase_fmks(int dtype_code, int integrator, const SimPhaseArgs& a);
cudaError_t launch_simulation_phase_mixture_fmks(int dtype_code, int integrator,
                                                 const SimPhaseArgs& a);
// The phase kernel on a CKS grid (the CKS modes); defined in
// simulation_phase_cks.cu, the mixture's in simulation_phase_mixture_cks.cu.
cudaError_t launch_simulation_phase_cks(int dtype_code, int integrator, const SimPhaseArgs& a);
cudaError_t launch_simulation_phase_mixture_cks(int dtype_code, int integrator,
                                                const SimPhaseArgs& a);

}  // namespace bl
