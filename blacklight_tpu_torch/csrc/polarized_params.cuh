// Index order of the float64 parameter vector the polarized kernel reads:
// the simulation kernel's (simulation_params.cuh), then these.
//
// The host (blacklight_tpu_torch/ops/polarized_kernel.py, PARAM_NAMES)
// fills it in this order; tests/test_torch_polarized_parts.py checks that
// the two orders agree. Flags are stored as 0.0 / 1.0.
#pragma once

#include "simulation_params.cuh"

namespace bl {

enum PolarizedParam : int {
  P_ROTATION_SPLIT = S_COUNT,  // image_rotation_split
  P_FALLBACK_RHO,              // the sampler's off-grid values
  P_FALLBACK_PGAS,
  P_E_SQUARED,  // e^2 and m_e c of the Faraday rotativities
  P_ME_C,
  P_COUNT
};

}  // namespace bl
