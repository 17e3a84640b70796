// The polarized route's chain kernel (polarized_kernel.cuh,
// polarized_chain_kernel) in float and double for one and for
// POL_MAX_FREQUENCIES frequencies, and the C interface of the three
// kernels. Built without multiply-add contraction (-fmad=false), like
// every polarized unit, so that each operation rounds as the plain
// PyTorch version's does.

#include "polarized_kernel.cuh"

namespace {

static_assert(static_cast<int>(bl::P_ROTATION_SPLIT) == static_cast<int>(bl::S_COUNT),
              "the polarized parameters follow the simulation parameters");

bool sizes_ok(int cap, long long n_rays, int n_warps) {
  return cap >= 1 && n_rays >= 0 && n_warps >= 0 &&
         static_cast<long long>(n_warps) * bl::POL_WARP >= n_rays;
}

}  // namespace

// Plain C interface, bound with ctypes by ops/polarized_kernel.py. Each
// launches on `stream`, does not synchronize, allocates nothing and
// returns the cudaError_t of the launch. dtype_code: 0 float32, 1 float64;
// integrator: 0 dp, 1 rk4, 2 rk2. Rays, frequencies and coordinates are
// in the working type; table is (n_k, n_j, n_i, 8) float32; coords holds
// x1f, x1v, x2f, x2v, x3f, x3v; guides and axes (a host array) are the
// axes' guides as blacklight_simulation_launch takes them.
//
// Trace: n_rays rays; samples receives ceil(n_rays / 32) warps of `cap`
// slots (cap >= ray_max_steps) of POL_SAMPLE_VALUES values x 32 lanes;
// flags and n_samples one int32 per ray.
extern "C" int blacklight_polarized_trace(int dtype_code, int integrator, const void* positions,
                                          const void* directions, const void* params,
                                          void* samples, int cap, void* flags, void* n_samples,
                                          long long n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bl::PolTraceArgs a{positions,
                           directions,
                           static_cast<const double*>(params),
                           samples,
                           cap,
                           static_cast<int*>(flags),
                           static_cast<int*>(n_samples),
                           n_rays,
                           static_cast<cudaStream_t>(stream)};
  return static_cast<int>(bl::launch_polarized_trace_any(dtype_code, integrator, a));
}

// Derive: the records of the n_slots slots of n_warps warps of rays whose
// first slots are offsets (int64, n_warps + 1 entries, offsets[n_warps] =
// n_slots); geometry (nonzero) writes POL_GEOMETRY_VALUES values per slot
// and lane into geometry_records; every launch writes
// POL_COEFFICIENT_VALUES per frequency (nf <= POL_MAX_FREQUENCIES) into
// coefficient_records and ORs bit f of bad (one int32 per ray) where
// frequency f met a sample the reference would NaN. The snapshot (table
// ... map) as blacklight_simulation_launch takes it.
extern "C" int blacklight_polarized_derive(
    int dtype_code, int geometry, const void* samples, int cap, const void* n_samples,
    const void* offsets, int n_warps, long long n_slots, long long n_rays,
    const void* directions, const void* momentum_factors, const void* freqs, int nf,
    const void* params, const void* table, const void* coords, const void* guides,
    const void* axes, int n_i, int n_j, int n_k, int mode, int nearest, int n_b,
    const void* bounds, const void* amr, const void* parity, const void* map,
    void* geometry_records, void* coefficient_records, void* bad, void* stream) {
  if (n_slots <= 0) return 0;
  const bl::SimGridArgs grid{static_cast<const float*>(table),
                             coords,
                             static_cast<const int*>(guides),
                             static_cast<const double*>(axes),
                             n_i,
                             n_j,
                             n_k,
                             mode,
                             nearest != 0,
                             n_b,
                             bounds,
                             static_cast<const int*>(amr),
                             static_cast<const int*>(parity),
                             map};
  if (!sizes_ok(cap, n_rays, n_warps) || nf < 1 || nf > bl::POL_MAX_FREQUENCIES ||
      !grid.valid()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bl::PolDeriveArgs a{{samples, cap, static_cast<const int*>(n_samples),
                             static_cast<const long long*>(offsets), n_warps, n_rays},
                            n_slots,
                            geometry != 0,
                            directions,
                            momentum_factors,
                            freqs,
                            nf,
                            static_cast<const double*>(params),
                            grid,
                            geometry_records,
                            coefficient_records,
                            static_cast<int*>(bad),
                            static_cast<cudaStream_t>(stream)};
  if (mode == bl::SAMPLE_FMKS) {
    return static_cast<int>(bl::launch_polarized_derive_fmks(dtype_code, bl::POP_THERMAL, a));
  }
  if (bl::is_cks_mode(mode)) {
    return static_cast<int>(bl::launch_polarized_derive_cks(dtype_code, bl::POP_THERMAL, a));
  }
  if (mode != bl::SAMPLE_SINGLE) {
    return static_cast<int>(bl::launch_polarized_derive_blocks(dtype_code, a));
  }
  cudaError_t err;
  switch (dtype_code) {
    case 0:
      err = bl::launch_polarized_derive_f32(a);
      break;
    case 1:
      err = bl::launch_polarized_derive_f64(a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Chain: one thread per ray of n_warps warps, taken in `order` (int32, a
// permutation of the warps); nn receives (n_rays, nf, 16) coherency
// components.
extern "C" int blacklight_polarized_chain(int dtype_code, const void* samples, int cap,
                                          const void* n_samples, const void* offsets,
                                          int n_warps, long long n_rays, const void* order,
                                          const void* geometry_records,
                                          const void* coefficient_records, int nf,
                                          const void* params, void* nn, void* stream) {
  if (n_rays <= 0) return 0;
  if (!sizes_ok(cap, n_rays, n_warps) || nf < 1 || nf > bl::POL_MAX_FREQUENCIES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bl::PolChainArgs a{{samples, cap, static_cast<const int*>(n_samples),
                            static_cast<const long long*>(offsets), n_warps, n_rays},
                           static_cast<const int*>(order),
                           geometry_records,
                           coefficient_records,
                           nf,
                           static_cast<const double*>(params),
                           nn,
                           static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dtype_code) {
    case 0:
      err = bl::launch_polarized_chain<float>(a);
      break;
    case 1:
      err = bl::launch_polarized_chain<double>(a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int blacklight_polarized_param_count() { return bl::P_COUNT; }

extern "C" int blacklight_polarized_max_frequencies() { return bl::POL_MAX_FREQUENCIES; }

// Values per stored sample, per record's geometry part and per frequency
// of a record's coefficients (ops/polarized_kernel.py sizes the buffers).
extern "C" int blacklight_polarized_sample_values() { return bl::POL_SAMPLE_VALUES; }

extern "C" int blacklight_polarized_geometry_values() { return bl::POL_GEOMETRY_VALUES; }

extern "C" int blacklight_polarized_coefficient_values() { return bl::POL_COEFFICIENT_VALUES; }
