// The polarized route's derive kernel on a CKS grid (polarized_kernel.cuh
// polarized_derive_mode_kernel and, for the mixture,
// polarized_derive_mixture_kernel, modes SAMPLE_CKS_BLOCKS and
// SAMPLE_CKS_INTERBLOCK) in double, a unit of its own so that nvcc builds
// it beside the float one. Built without multiply-add contraction.

#include "polarized_kernel.cuh"

namespace bl {

cudaError_t launch_polarized_derive_cks_f64(int pop, const PolDeriveArgs& a) {
  const bool inter = a.grid.mode == SAMPLE_CKS_INTERBLOCK;
  if (pop == POP_MIXTURE) {
    return inter ? launch_polarized_derive<double, SAMPLE_CKS_INTERBLOCK, POP_MIXTURE>(a)
                 : launch_polarized_derive<double, SAMPLE_CKS_BLOCKS, POP_MIXTURE>(a);
  }
  return inter ? launch_polarized_derive<double, SAMPLE_CKS_INTERBLOCK>(a)
               : launch_polarized_derive<double, SAMPLE_CKS_BLOCKS>(a);
}

}  // namespace bl
