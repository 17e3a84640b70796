// C interface of the fused simulation-model kernel (simulation_kernel.cuh)
// and its rk4 and rk2 instantiations. Like formula_kernel.cu, this unit is
// built without multiply-add contraction (-fmad=false), so that each
// operation rounds as the plain PyTorch version's does and float64 rk4/rk2
// keep identical flags and n_samples with it.

#include "simulation_kernel.cuh"

namespace bl {

template <typename T>
cudaError_t launch_simulation_rk(int integrator, const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_nf<T, INTEGRATOR_RK4>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_nf<T, INTEGRATOR_RK2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl

// Plain C interface, bound with ctypes by ops/simulation_kernel.py.
// dtype_code: 0 float32, 1 float64. integrator: 0 dp, 1 rk4, 2 rk2.
// freqs holds the nf frequencies, then the nf image scales, in the rays'
// type; table is (n_k, n_j, n_i, 8) float32; coords holds x1f, x1v, x2f,
// x2v, x3f, x3v in the rays' type. Launches on `stream`, does not
// synchronize, allocates nothing; returns the cudaError_t of the launch.
extern "C" int blacklight_simulation_launch(
    int dtype_code, int integrator, const void* positions, const void* directions,
    const void* momentum_factors, const void* freqs, int nf, const void* params,
    const void* table, const void* coords, int n_i, int n_j, int n_k, void* i_nu,
    void* flags, void* n_samples, long long n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  if (nf < 1 || nf > bl::MAX_FREQUENCIES || n_i < 2 || n_j < 2 || n_k < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bl::SimLaunchArgs a{positions,
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
                            i_nu,
                            static_cast<int*>(flags),
                            static_cast<int*>(n_samples),
                            n_rays,
                            static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (integrator == bl::INTEGRATOR_DP) {
    err = bl::launch_simulation_dp(dtype_code, a);
  } else if (dtype_code == 0) {
    err = bl::launch_simulation_rk<float>(integrator, a);
  } else if (dtype_code == 1) {
    err = bl::launch_simulation_rk<double>(integrator, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int blacklight_simulation_param_count() { return bl::S_COUNT; }

extern "C" int blacklight_simulation_max_frequencies() { return bl::MAX_FREQUENCIES; }
