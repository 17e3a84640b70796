// rk4 and rk2 instantiations of the mixture's simulation kernel on grids of
// many mesh blocks or at the nearest cell (simulation_kernel.cuh
// simulation_mixture_kernel, modes SAMPLE_BLOCKS and SAMPLE_INTERBLOCK).
// Built without multiply-add contraction, as simulation_blocks.cu.

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_mixture_rk_blocks(int dtype_code, int integrator,
                                                const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_blocks<INTEGRATOR_RK4, POP_MIXTURE>(dtype_code, a);
    case INTEGRATOR_RK2:
      return launch_simulation_blocks<INTEGRATOR_RK2, POP_MIXTURE>(dtype_code, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
