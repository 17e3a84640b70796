// The polarized route's derive kernel (polarized_kernel.cuh,
// polarized_derive_kernel) in float, with and without the geometry part
// of the record. Built without multiply-add contraction.

#include "polarized_kernel.cuh"

namespace bl {

cudaError_t launch_polarized_derive_f32(const PolDeriveArgs& a) {
  return launch_polarized_derive<float>(a);
}

}  // namespace bl
