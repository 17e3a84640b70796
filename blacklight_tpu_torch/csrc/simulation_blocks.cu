// rk4 and rk2 instantiations of the simulation kernel on grids of many
// mesh blocks or at the nearest cell (simulation_kernel.cuh
// simulation_mode_kernel, modes SAMPLE_BLOCKS and SAMPLE_INTERBLOCK), in
// a unit of their own so that nvcc builds them beside the single-block
// units. Built without multiply-add contraction, as simulation_kernel.cu.

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_rk_blocks(int dtype_code, int integrator, const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_blocks<INTEGRATOR_RK4>(dtype_code, a);
    case INTEGRATOR_RK2:
      return launch_simulation_blocks<INTEGRATOR_RK2>(dtype_code, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
