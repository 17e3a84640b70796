// The polarized route's derive kernel on one FMKS block
// (polarized_kernel.cuh polarized_derive_fmks_kernel and, for the mixture,
// polarized_derive_mixture_kernel, mode SAMPLE_FMKS) in double, a unit of
// its own so that nvcc builds it beside the float one. Built without
// multiply-add contraction.

#include "polarized_kernel.cuh"

namespace bl {

cudaError_t launch_polarized_derive_fmks_f64(int pop, const PolDeriveArgs& a) {
  if (pop == POP_MIXTURE) return launch_polarized_derive<double, SAMPLE_FMKS, POP_MIXTURE>(a);
  return launch_polarized_derive<double, SAMPLE_FMKS>(a);
}

}  // namespace bl
