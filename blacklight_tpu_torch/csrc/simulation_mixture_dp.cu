// dp instantiations of the mixture's simulation kernel on one block
// (simulation_kernel.cuh simulation_mixture_kernel), beside the rk4/rk2
// unit. Built without multiply-add contraction, as simulation_kernel_dp.cu.

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_mixture_dp(int dtype_code, const SimLaunchArgs& a) {
  if (dtype_code == 0) return launch_simulation_nf<float, INTEGRATOR_DP, SAMPLE_SINGLE, POP_MIXTURE>(a);
  if (dtype_code == 1) return launch_simulation_nf<double, INTEGRATOR_DP, SAMPLE_SINGLE, POP_MIXTURE>(a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
