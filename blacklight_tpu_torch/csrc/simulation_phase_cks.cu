// The phase kernel of phased dispatch on a CKS grid (simulation_kernel.cuh
// simulation_phase_mode_kernel, modes SAMPLE_CKS_BLOCKS and
// SAMPLE_CKS_INTERBLOCK): rk4 and rk2 in float and double at one frequency
// and up to MAX_FREQUENCIES. Built without multiply-add contraction, so
// that a phased render gives the monolithic kernel's image bit for bit.

#include "simulation_kernel.cuh"

namespace bl {

namespace {

template <int INTEGRATOR>
cudaError_t launch_phase_cks(int dtype_code, const SimPhaseArgs& a) {
  const bool inter = a.grid.mode == SAMPLE_CKS_INTERBLOCK;
  if (dtype_code == 0) {
    return inter ? launch_simulation_phase_nf<float, INTEGRATOR, SAMPLE_CKS_INTERBLOCK>(a)
                 : launch_simulation_phase_nf<float, INTEGRATOR, SAMPLE_CKS_BLOCKS>(a);
  }
  if (dtype_code == 1) {
    return inter ? launch_simulation_phase_nf<double, INTEGRATOR, SAMPLE_CKS_INTERBLOCK>(a)
                 : launch_simulation_phase_nf<double, INTEGRATOR, SAMPLE_CKS_BLOCKS>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_simulation_phase_cks(int dtype_code, int integrator, const SimPhaseArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_phase_cks<INTEGRATOR_RK4>(dtype_code, a);
    case INTEGRATOR_RK2:
      return launch_phase_cks<INTEGRATOR_RK2>(dtype_code, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
