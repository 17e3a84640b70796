// The polarized route's derive kernel on grids of many mesh blocks or at
// the nearest cell (polarized_kernel.cuh, polarized_derive_mode_kernel,
// modes SAMPLE_BLOCKS and SAMPLE_INTERBLOCK) in float and double, with and
// without the geometry part of the record. Built without multiply-add
// contraction.

#include "polarized_kernel.cuh"

namespace bl {

namespace {

template <typename T>
cudaError_t launch_blocks(const PolDeriveArgs& a) {
  if (a.grid.mode == SAMPLE_INTERBLOCK) return launch_polarized_derive<T, SAMPLE_INTERBLOCK>(a);
  return launch_polarized_derive<T, SAMPLE_BLOCKS>(a);
}

}  // namespace

cudaError_t launch_polarized_derive_blocks(int dtype_code, const PolDeriveArgs& a) {
  if (dtype_code == 0) return launch_blocks<float>(a);
  if (dtype_code == 1) return launch_blocks<double>(a);
  return cudaErrorInvalidValue;
}

}  // namespace bl
