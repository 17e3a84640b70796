// The mixture's derive kernel (polarized_kernel.cuh,
// polarized_derive_mixture_kernel) in double on one block, a unit of its
// own so that nvcc builds it beside the float one. Built without
// multiply-add contraction.

#include "polarized_kernel.cuh"

namespace bl {

cudaError_t launch_polarized_derive_mixture_f64(const PolDeriveArgs& a) {
  return launch_polarized_derive<double, SAMPLE_SINGLE, POP_MIXTURE>(a);
}

}  // namespace bl
