// dp instantiations of the mixture's simulation kernel on grids of many
// mesh blocks or at the nearest cell (simulation_kernel.cuh
// simulation_mixture_kernel, modes SAMPLE_BLOCKS and SAMPLE_INTERBLOCK).
// Built without multiply-add contraction, as simulation_blocks_dp.cu.

#include "simulation_kernel.cuh"

namespace bl {

cudaError_t launch_simulation_mixture_dp_blocks(int dtype_code, const SimLaunchArgs& a) {
  return launch_simulation_blocks<INTEGRATOR_DP, POP_MIXTURE>(dtype_code, a);
}

}  // namespace bl
