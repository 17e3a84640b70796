// rk4 and rk2 instantiations of the fused formula-model kernel
// (formula_kernel.cuh) for 2..FORMULA_MAX_FREQUENCIES frequencies without
// tangents (K1.3). Built without multiply-add contraction, as
// formula_kernel.cu is and for its reason: float64 rk4/rk2 then agree with
// the plain version within rtol 1e-9 with identical flags and n_samples.

#include "formula_kernel.cuh"

namespace bl {

cudaError_t launch_multi_rk(int dtype_code, int integrator, const LaunchArgs& a) {
  return launch_rk<FORMULA_MAX_FREQUENCIES, false>(dtype_code, integrator, a);
}

}  // namespace bl
