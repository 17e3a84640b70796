// The mixture's phase kernel on a CKS grid (simulation_kernel.cuh
// simulation_phase_mixture_kernel, modes SAMPLE_CKS_BLOCKS and
// SAMPLE_CKS_INTERBLOCK): rk4 and rk2 in float and double. Built without
// multiply-add contraction, as simulation_phase_cks.cu.

#include "simulation_kernel.cuh"

namespace bl {

namespace {

template <int INTEGRATOR>
cudaError_t launch_phase_mixture_cks(int dtype_code, const SimPhaseArgs& a) {
  const bool inter = a.grid.mode == SAMPLE_CKS_INTERBLOCK;
  if (dtype_code == 0) {
    return inter ? launch_simulation_phase_nf<float, INTEGRATOR, SAMPLE_CKS_INTERBLOCK,
                                              POP_MIXTURE>(a)
                 : launch_simulation_phase_nf<float, INTEGRATOR, SAMPLE_CKS_BLOCKS, POP_MIXTURE>(
                       a);
  }
  if (dtype_code == 1) {
    return inter ? launch_simulation_phase_nf<double, INTEGRATOR, SAMPLE_CKS_INTERBLOCK,
                                              POP_MIXTURE>(a)
                 : launch_simulation_phase_nf<double, INTEGRATOR, SAMPLE_CKS_BLOCKS, POP_MIXTURE>(
                       a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_simulation_phase_mixture_cks(int dtype_code, int integrator,
                                                const SimPhaseArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_phase_mixture_cks<INTEGRATOR_RK4>(dtype_code, a);
    case INTEGRATOR_RK2:
      return launch_phase_mixture_cks<INTEGRATOR_RK2>(dtype_code, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
