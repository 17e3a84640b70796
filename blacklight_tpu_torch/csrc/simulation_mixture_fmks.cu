// The mixture's simulation kernel on one FMKS block (simulation_kernel.cuh
// simulation_mixture_kernel, mode SAMPLE_FMKS): rk4, rk2 and dp in float
// and double, at MAX_FREQUENCIES (which takes one frequency too). Built
// without multiply-add contraction, as simulation_mixture.cu.

#include "simulation_kernel.cuh"

namespace bl {

namespace {

template <typename T>
cudaError_t launch_mixture_fmks(int integrator, const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_DP:
      return launch_simulation_nf<T, INTEGRATOR_DP, SAMPLE_FMKS, POP_MIXTURE>(a);
    case INTEGRATOR_RK4:
      return launch_simulation_nf<T, INTEGRATOR_RK4, SAMPLE_FMKS, POP_MIXTURE>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_nf<T, INTEGRATOR_RK2, SAMPLE_FMKS, POP_MIXTURE>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_simulation_mixture_fmks(int dtype_code, int integrator,
                                           const SimLaunchArgs& a) {
  if (dtype_code == 0) return launch_mixture_fmks<float>(integrator, a);
  if (dtype_code == 1) return launch_mixture_fmks<double>(integrator, a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
