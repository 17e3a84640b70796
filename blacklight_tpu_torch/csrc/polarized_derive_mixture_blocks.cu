// The mixture's derive kernel (polarized_kernel.cuh,
// polarized_derive_mixture_kernel) on grids of many mesh blocks or at the
// nearest cell (modes SAMPLE_BLOCKS and SAMPLE_INTERBLOCK) in float and
// double, with and without the geometry part of the record. Built without
// multiply-add contraction.

#include "polarized_kernel.cuh"

namespace bl {

namespace {

template <typename T>
cudaError_t launch_mixture_blocks(const PolDeriveArgs& a) {
  if (a.grid.mode == SAMPLE_INTERBLOCK) {
    return launch_polarized_derive<T, SAMPLE_INTERBLOCK, POP_MIXTURE>(a);
  }
  return launch_polarized_derive<T, SAMPLE_BLOCKS, POP_MIXTURE>(a);
}

}  // namespace

cudaError_t launch_polarized_derive_mixture_blocks(int dtype_code, const PolDeriveArgs& a) {
  if (dtype_code == 0) return launch_mixture_blocks<float>(a);
  if (dtype_code == 1) return launch_mixture_blocks<double>(a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
