// dp instantiations of the fused simulation-model kernel
// (simulation_kernel.cuh), in a unit of their own so that nvcc builds them
// beside the rk4/rk2 unit. Unlike the formula kernel's dp unit, this one
// is built without multiply-add contraction: with it, float32 dp takes
// other accept/reject decisions than the plain PyTorch version, and on a
// trilinear grid the image moves by ~3e-3 with the step sequence (60 % of
// pixels past the statistical gate's 1e-3 at 128^2 on an H100); without,
// flags and sample counts agree and the image to 1e-6, for 6 % of speed
// (PERF.md).

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_dp(int dtype_code, const SimLaunchArgs& a) {
  if (dtype_code == 0) return launch_simulation_nf<float, INTEGRATOR_DP>(a);
  if (dtype_code == 1) return launch_simulation_nf<double, INTEGRATOR_DP>(a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
