// C interface of the fused polarized kernel (polarized_kernel.cuh) and its
// rk4 and rk2 instantiations in float. Built without multiply-add
// contraction (-fmad=false), like every polarized unit, so that each
// operation rounds as the plain PyTorch version's does.

#include "polarized_kernel.cuh"

namespace bl {

static_assert(P_ROTATION_SPLIT == S_COUNT,
              "the polarized parameters follow the simulation parameters");

cudaError_t launch_polarized_rk_f32(int integrator, const PolLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_polarized_nf<float, INTEGRATOR_RK4>(a);
    case INTEGRATOR_RK2:
      return launch_polarized_nf<float, INTEGRATOR_RK2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl

// Plain C interface, bound with ctypes by ops/polarized_kernel.py.
// dtype_code: 0 float32, 1 float64. integrator: 0 dp, 1 rk4, 2 rk2.
// freqs holds nf <= POL_MAX_FREQUENCIES frequencies in the rays' type;
// table is (n_k, n_j, n_i, 8) float32; coords holds x1f, x1v, x2f, x2v,
// x3f, x3v in the rays' type. nn receives (n_rays, nf, 16) coherency
// components, flags, n_samples and bad (bit f: frequency f) one int32 per
// ray. carries is scratch for n_windows windows of `window` steps: per
// window POL_CARRY_REALS values in the rays' type and POL_CARRY_INTS int32
// per ray. Launches on `stream`, does not synchronize, allocates nothing;
// returns the cudaError_t of the launch.
extern "C" int blacklight_polarized_launch(
    int dtype_code, int integrator, const void* positions, const void* directions,
    const void* momentum_factors, const void* freqs, int nf, const void* params,
    const void* table, const void* coords, int n_i, int n_j, int n_k, void* nn, void* flags,
    void* n_samples, void* bad, void* carries, int window, int n_windows, long long n_rays,
    void* stream) {
  if (n_rays <= 0) return 0;
  if (nf < 1 || nf > bl::POL_MAX_FREQUENCIES || n_i < 2 || n_j < 2 || n_k < 2 || window < 1 ||
      window > bl::POL_MAX_WINDOW || n_windows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bl::PolLaunchArgs a{positions,
                            directions,
                            momentum_factors,
                            freqs,
                            nf,
                            static_cast<const double*>(params),
                            static_cast<const float*>(table),
                            coords,
                            n_i,
                            n_j,
                            n_k,
                            nn,
                            static_cast<int*>(flags),
                            static_cast<int*>(n_samples),
                            static_cast<int*>(bad),
                            carries,
                            window,
                            n_windows,
                            n_rays,
                            static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (integrator == bl::INTEGRATOR_DP) {
    err = bl::launch_polarized_dp(dtype_code, a);
  } else if (dtype_code == 0) {
    err = bl::launch_polarized_rk_f32(integrator, a);
  } else if (dtype_code == 1) {
    err = bl::launch_polarized_rk_f64(integrator, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int blacklight_polarized_param_count() { return bl::P_COUNT; }

extern "C" int blacklight_polarized_max_frequencies() { return bl::POL_MAX_FREQUENCIES; }

extern "C" int blacklight_polarized_max_window() { return bl::POL_MAX_WINDOW; }
