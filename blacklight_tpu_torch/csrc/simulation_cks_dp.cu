// dp instantiations of the simulation kernel on a CKS grid
// (simulation_kernel.cuh simulation_mode_kernel, modes SAMPLE_CKS_BLOCKS and
// SAMPLE_CKS_INTERBLOCK). Built without multiply-add contraction, as
// simulation_kernel_dp.cu.

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_cks_dp(int dtype_code, const SimLaunchArgs& a) {
  return launch_simulation_cks_modes<INTEGRATOR_DP>(dtype_code, a);
}

}  // namespace bl
