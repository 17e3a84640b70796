// The polarized route's trace kernel (polarized_kernel.cuh,
// polarized_trace_kernel) for float and double and dp, rk4 and rk2, a unit
// of its own so that nvcc builds it beside the others. Built without
// multiply-add contraction, like every polarized unit: the samples are
// those of the simulation kernel's step_ray, rounded alike.

#include "polarized_kernel.cuh"

namespace bl {

template <typename T>
static cudaError_t launch_trace_t(int integrator, const PolTraceArgs& a) {
  switch (integrator) {
    case INTEGRATOR_DP:
      return launch_polarized_trace<T, INTEGRATOR_DP>(a);
    case INTEGRATOR_RK4:
      return launch_polarized_trace<T, INTEGRATOR_RK4>(a);
    case INTEGRATOR_RK2:
      return launch_polarized_trace<T, INTEGRATOR_RK2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_polarized_trace_any(int dtype_code, int integrator, const PolTraceArgs& a) {
  switch (dtype_code) {
    case 0:
      return launch_trace_t<float>(integrator, a);
    case 1:
      return launch_trace_t<double>(integrator, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl
