// The mixture's phase kernel on one FMKS block (simulation_kernel.cuh
// simulation_phase_mixture_kernel, mode SAMPLE_FMKS): rk4 and rk2 in float
// and double. Built without multiply-add contraction, as
// simulation_phase_fmks.cu.

#include "simulation_kernel.cuh"

namespace bl {

namespace {

template <typename T>
cudaError_t launch_phase_mixture_fmks(int integrator, const SimPhaseArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_phase_nf<T, INTEGRATOR_RK4, SAMPLE_FMKS, POP_MIXTURE>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_phase_nf<T, INTEGRATOR_RK2, SAMPLE_FMKS, POP_MIXTURE>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_simulation_phase_mixture_fmks(int dtype_code, int integrator,
                                                 const SimPhaseArgs& a) {
  if (dtype_code == 0) return launch_phase_mixture_fmks<float>(integrator, a);
  if (dtype_code == 1) return launch_phase_mixture_fmks<double>(integrator, a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
