// Dormand-Prince instantiations of the fused polarized kernel
// (polarized_kernel.cuh) in float and double. Built without multiply-add
// contraction, like the simulation kernel's dp unit: on a grid, float32
// dp's image follows its exact step sequence.

#include "polarized_kernel.cuh"

namespace bl {

cudaError_t launch_polarized_dp(int dtype_code, const PolLaunchArgs& a) {
  switch (dtype_code) {
    case 0:
      return launch_polarized_nf<float, INTEGRATOR_DP>(a);
    case 1:
      return launch_polarized_nf<double, INTEGRATOR_DP>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
