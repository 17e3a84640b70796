// The phase kernel of phased dispatch on one FMKS block
// (simulation_kernel.cuh simulation_phase_fmks_kernel, mode SAMPLE_FMKS):
// rk4 and rk2 in float and double at one frequency and up to
// MAX_FREQUENCIES. Built without multiply-add contraction, so that a phased
// render gives the monolithic kernel's image bit for bit.

#include "simulation_kernel.cuh"

namespace bl {

namespace {

template <typename T>
cudaError_t launch_phase_fmks(int integrator, const SimPhaseArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_phase_nf<T, INTEGRATOR_RK4, SAMPLE_FMKS>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_phase_nf<T, INTEGRATOR_RK2, SAMPLE_FMKS>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_simulation_phase_fmks(int dtype_code, int integrator, const SimPhaseArgs& a) {
  if (dtype_code == 0) return launch_phase_fmks<float>(integrator, a);
  if (dtype_code == 1) return launch_phase_fmks<double>(integrator, a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
