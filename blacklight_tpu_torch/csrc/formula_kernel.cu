// C interface of the fused formula-model kernel (formula_kernel.cuh) and
// its rk4 and rk2 instantiations. This unit is built without multiply-add
// contraction (-fmad=false): each operation then rounds as the plain
// PyTorch version's one-op-per-launch arithmetic does, and chaotic
// photon-ring rays, which amplify a one-ulp difference to 1e-7 in I_nu,
// keep float64 rk4/rk2 within rtol 1e-9 of it with identical flags and
// n_samples, and float32 rk4/rk2 inside the statistical gate.

#include "formula_kernel.cuh"

namespace bl {

template <typename T>
cudaError_t launch_rk(int integrator, const LaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch<T, INTEGRATOR_RK4>(a);
    case INTEGRATOR_RK2:
      return launch<T, INTEGRATOR_RK2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl

// Plain C interface, bound with ctypes by ops/formula_kernel.py.
// dtype_code: 0 float32, 1 float64. integrator: 0 dp, 1 rk4, 2 rk2.
// Launches on `stream`, does not synchronize, allocates nothing; returns
// the cudaError_t of the launch (0 on success).
extern "C" int blacklight_formula_launch(int dtype_code, int integrator,
                                         const void* positions, const void* directions,
                                         const void* momentum_factors,
                                         const void* params, void* i_nu, void* flags,
                                         void* n_samples, long long n_rays,
                                         void* stream) {
  if (n_rays <= 0) return 0;
  const bl::LaunchArgs a{positions,
                         directions,
                         momentum_factors,
                         static_cast<const double*>(params),
                         i_nu,
                         static_cast<int*>(flags),
                         static_cast<int*>(n_samples),
                         n_rays,
                         static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (integrator == bl::INTEGRATOR_DP) {
    err = bl::launch_dp(dtype_code, a);
  } else if (dtype_code == 0) {
    err = bl::launch_rk<float>(integrator, a);
  } else if (dtype_code == 1) {
    err = bl::launch_rk<double>(integrator, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int blacklight_formula_param_count() { return bl::P_COUNT; }

extern "C" const char* blacklight_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
