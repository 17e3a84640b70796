// dp instantiations of the fused formula-model kernel (formula_kernel.cuh)
// for 2..FORMULA_MAX_FREQUENCIES frequencies without tangents (K1.3).
// Built with multiply-add contraction, as formula_kernel_dp.cu is: dp's
// agreement with the plain version is statistical either way.

#include "formula_kernel.cuh"

namespace bl {

cudaError_t launch_multi_dp(int dtype_code, const LaunchArgs& a) {
  return launch_typed<INTEGRATOR_DP, FORMULA_MAX_FREQUENCIES, false>(dtype_code, a);
}

}  // namespace bl
