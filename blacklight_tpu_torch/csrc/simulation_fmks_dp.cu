// dp instantiations of the simulation kernel on one FMKS block
// (simulation_kernel.cuh simulation_fmks_kernel, mode SAMPLE_FMKS). Built
// without multiply-add contraction, as simulation_kernel_dp.cu.

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_fmks_dp(int dtype_code, const SimLaunchArgs& a) {
  if (dtype_code == 0) return launch_simulation_nf<float, INTEGRATOR_DP, SAMPLE_FMKS>(a);
  if (dtype_code == 1) return launch_simulation_nf<double, INTEGRATOR_DP, SAMPLE_FMKS>(a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
