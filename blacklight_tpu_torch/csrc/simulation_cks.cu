// rk4 and rk2 instantiations of the simulation kernel on a CKS grid
// (AthenaK's Cartesian Kerr-Schild mesh blocks; simulation_kernel.cuh
// simulation_mode_kernel in the modes SAMPLE_CKS_BLOCKS and
// SAMPLE_CKS_INTERBLOCK),
// in a unit of its own so that nvcc builds it beside the others and they
// stay as they were; dp is in simulation_cks_dp.cu. Built without
// multiply-add contraction, as simulation_kernel.cu.

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_cks(int dtype_code, int integrator, const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_DP:
      return launch_simulation_cks_dp(dtype_code, a);
    case INTEGRATOR_RK4:
      return launch_simulation_cks_modes<INTEGRATOR_RK4>(dtype_code, a);
    case INTEGRATOR_RK2:
      return launch_simulation_cks_modes<INTEGRATOR_RK2>(dtype_code, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
