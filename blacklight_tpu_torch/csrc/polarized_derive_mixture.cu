// The polarized route's derive kernel of the thermal, power-law and kappa
// populations summed (polarized_kernel.cuh polarized_derive_mixture_kernel,
// POP_MIXTURE) in float on one block, with and without the geometry part of
// the record, and its C interface; double is in
// polarized_derive_mixture_f64.cu and many blocks in
// polarized_derive_mixture_blocks.cu. Built without multiply-add
// contraction, like every polarized unit.

#include "polarized_kernel.cuh"

// Plain C interface, bound with ctypes by ops/polarized_kernel.py: the
// arguments of blacklight_polarized_derive (polarized_chain.cu), with
// params holding the MixtureParam values after its P_COUNT.
extern "C" int blacklight_polarized_derive_mixture(
    int dtype_code, int geometry, const void* samples, int cap, const void* n_samples,
    const void* offsets, int n_warps, long long n_slots, long long n_rays,
    const void* directions, const void* momentum_factors, const void* freqs, int nf,
    const void* params, const void* table, const void* coords, const void* guides,
    const void* axes, int n_i, int n_j, int n_k, int mode, int nearest, int n_b,
    const void* bounds, const void* amr, const void* parity, const void* map, const void* kappa,
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
                             map,
                             static_cast<const float*>(kappa)};
  if (cap < 1 || n_rays < 0 || n_warps < 0 ||
      static_cast<long long>(n_warps) * bl::POL_WARP < n_rays || nf < 1 ||
      nf > bl::POL_MAX_FREQUENCIES || !grid.valid()) {
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
  cudaError_t err;
  if (mode == bl::SAMPLE_FMKS) {
    err = bl::launch_polarized_derive_fmks(dtype_code, bl::POP_MIXTURE, a);
  } else if (bl::is_cks_mode(mode)) {
    err = bl::launch_polarized_derive_cks(dtype_code, bl::POP_MIXTURE, a);
  } else if (mode != bl::SAMPLE_SINGLE) {
    err = bl::launch_polarized_derive_mixture_blocks(dtype_code, a);
  } else if (dtype_code == 0) {
    err = bl::launch_polarized_derive<float, bl::SAMPLE_SINGLE, bl::POP_MIXTURE>(a);
  } else if (dtype_code == 1) {
    err = bl::launch_polarized_derive_mixture_f64(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The length of the parameter vector of a mixture launch.
extern "C" int blacklight_polarized_mixture_param_count() { return bl::P_COUNT + bl::M_COUNT; }
