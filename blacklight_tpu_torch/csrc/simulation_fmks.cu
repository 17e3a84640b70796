// rk4 and rk2 instantiations of the simulation kernel on one FMKS block
// (simulation_kernel.cuh simulation_fmks_kernel, mode SAMPLE_FMKS), in a
// unit of its own so that nvcc builds it beside the others and they stay
// as they were; dp is in simulation_fmks_dp.cu. Built without multiply-add
// contraction, as simulation_kernel.cu.

#include "simulation_kernel.cuh"

namespace bl {

namespace {

template <typename T>
cudaError_t launch_fmks_rk(int integrator, const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_nf<T, INTEGRATOR_RK4, SAMPLE_FMKS>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_nf<T, INTEGRATOR_RK2, SAMPLE_FMKS>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_simulation_fmks(int dtype_code, int integrator, const SimLaunchArgs& a) {
  if (integrator == INTEGRATOR_DP) return launch_simulation_fmks_dp(dtype_code, a);
  if (dtype_code == 0) return launch_fmks_rk<float>(integrator, a);
  if (dtype_code == 1) return launch_fmks_rk<double>(integrator, a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
