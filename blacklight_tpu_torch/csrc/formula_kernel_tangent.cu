// rk4 and rk2 instantiations of the fused formula-model kernel
// (formula_kernel.cuh) with forward tangents (K1.4), at one frequency and
// in the larger frequency bucket. Built without multiply-add contraction,
// as formula_kernel.cu is: float64 rk4/rk2 intensities and tangents then
// agree with the plain version within rtol 1e-9.

#include "formula_kernel.cuh"

namespace bl {

cudaError_t launch_tangent_rk(int dtype_code, int integrator, const LaunchArgs& a) {
  if (a.nf == 1) return launch_rk<1, true>(dtype_code, integrator, a);
  return launch_rk<FORMULA_MAX_FREQUENCIES, true>(dtype_code, integrator, a);
}

}  // namespace bl
