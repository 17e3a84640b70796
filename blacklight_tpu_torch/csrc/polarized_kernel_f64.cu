// rk4 and rk2 instantiations of the fused polarized kernel in double
// (polarized_kernel.cuh), a unit of its own so that nvcc builds it beside
// the others. Built without multiply-add contraction.

#include "polarized_kernel.cuh"

namespace bl {

cudaError_t launch_polarized_rk_f64(int integrator, const PolLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_polarized_nf<double, INTEGRATOR_RK4>(a);
    case INTEGRATOR_RK2:
      return launch_polarized_nf<double, INTEGRATOR_RK2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
