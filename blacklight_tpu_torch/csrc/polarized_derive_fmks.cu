// The polarized route's derive kernel on one FMKS block
// (polarized_kernel.cuh polarized_derive_fmks_kernel and, for the mixture,
// polarized_derive_mixture_kernel, mode SAMPLE_FMKS) in float, with and
// without the geometry part of the record; double is in
// polarized_derive_fmks_f64.cu. Built without multiply-add contraction.

#include "polarized_kernel.cuh"

namespace bl {

cudaError_t launch_polarized_derive_fmks(int dtype_code, int pop, const PolDeriveArgs& a) {
  if (dtype_code == 1) return launch_polarized_derive_fmks_f64(pop, a);
  if (dtype_code != 0) return cudaErrorInvalidValue;
  if (pop == POP_MIXTURE) return launch_polarized_derive<float, SAMPLE_FMKS, POP_MIXTURE>(a);
  return launch_polarized_derive<float, SAMPLE_FMKS>(a);
}

}  // namespace bl
