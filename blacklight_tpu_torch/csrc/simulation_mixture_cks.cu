// The mixture's simulation kernel on a CKS grid (simulation_kernel.cuh
// simulation_mixture_kernel, modes SAMPLE_CKS_BLOCKS and
// SAMPLE_CKS_INTERBLOCK): rk4, rk2 and dp in float and double, at
// MAX_FREQUENCIES (which takes one frequency too). Built without
// multiply-add contraction, as simulation_mixture.cu.

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_mixture_cks(int dtype_code, int integrator,
                                          const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_DP:
      return launch_simulation_cks_modes<INTEGRATOR_DP, POP_MIXTURE>(dtype_code, a);
    case INTEGRATOR_RK4:
      return launch_simulation_cks_modes<INTEGRATOR_RK4, POP_MIXTURE>(dtype_code, a);
    case INTEGRATOR_RK2:
      return launch_simulation_cks_modes<INTEGRATOR_RK2, POP_MIXTURE>(dtype_code, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
