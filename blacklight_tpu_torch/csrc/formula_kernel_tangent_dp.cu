// dp instantiations of the fused formula-model kernel (formula_kernel.cuh)
// with forward tangents (K1.4), at one frequency and in the larger
// frequency bucket. Built with multiply-add contraction, as
// formula_kernel_dp.cu is: dp's agreement with the plain version, tangents
// included, is statistical either way.

#include "formula_kernel.cuh"

namespace bl {

cudaError_t launch_tangent_dp(int dtype_code, const LaunchArgs& a) {
  if (a.nf == 1) return launch_typed<INTEGRATOR_DP, 1, true>(dtype_code, a);
  return launch_typed<INTEGRATOR_DP, FORMULA_MAX_FREQUENCIES, true>(dtype_code, a);
}

}  // namespace bl
