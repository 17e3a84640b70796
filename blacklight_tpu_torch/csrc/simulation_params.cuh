// Index order of the float64 parameter vector the simulation kernel reads.
//
// The host (blacklight_tpu_torch/ops/simulation_kernel.py, PARAM_NAMES)
// fills it in this order, with every derived constant folded in float64
// as the JAX package folds it in Python before it meets an array;
// tests/test_torch_simulation_pipeline.py checks that the two orders agree.
// Flags are stored as 0.0 / 1.0 and integers as exact doubles.
#pragma once

namespace bl {

enum SimulationParam : int {
  // geodesic block (trace.cuh GeodesicParam order)
  S_SPIN,
  S_A2,
  S_TWO_SPIN,
  S_TWO_A2,
  S_THREE_A2,
  S_TWO_MASS,
  S_FLAT,
  S_RAY_STEP,
  S_CAMERA_R,
  S_R_TERMINATE,
  S_R_HORIZON,
  S_TOL_ABS,
  S_TOL_REL,
  S_MAX_STEPS,
  S_MAX_RETRIES,
  S_FALLBACK_NAN,
  // geometric cuts (cuts.cuh CutParam order)
  S_CUT_NEAR,
  S_CUT_FAR,
  S_CUT_IN_ON,
  S_CUT_IN,
  S_CUT_OUT_ON,
  S_CUT_OUT,
  S_CUT_MID_THETA_SIGN,
  S_CUT_MID_THETA,
  S_CUT_MID_Z_SIGN,
  S_CUT_MID_Z,
  S_CUT_PLANE,
  S_PLANE_OX,
  S_PLANE_OY,
  S_PLANE_OZ,
  S_PLANE_NX,
  S_PLANE_NY,
  S_PLANE_NZ,
  // fluid state (models/synchrotron.py fluid_state)
  S_D_UNIT,
  S_E_UNIT,
  S_B_UNIT,
  S_MU_MP,
  S_NE_DIV,
  S_RAT_HIGH,
  S_RAT_LOW,
  S_KB_TOT,
  S_USE_P,
  S_ONE_PLUS_NE_NI,
  S_NE_NI,
  S_GAMMA_M1,
  S_GAMMA_I_M1,
  S_NE_NI_OVER_GAMMA_E_M1,
  S_ME_C2,
  // value cuts, min and max; a negative value is off
  S_RHO_MIN,
  S_RHO_MAX,
  S_N_E_MIN,
  S_N_E_MAX,
  S_P_GAS_MIN,
  S_P_GAS_MAX,
  S_THETA_E_MIN,
  S_THETA_E_MAX,
  S_B_MIN,
  S_B_MAX,
  S_SIGMA_MIN,
  S_SIGMA_MAX,
  S_BETA_INV_MIN,
  S_BETA_INV_MAX,
  // thermal synchrotron (models/synchrotron.py thermal_coefficients)
  S_THERMAL_FRAC,
  S_E_CHARGE,
  S_NU_C_DIV,
  S_TWO_NINTHS,
  S_VAR_A,
  S_VAR_B,
  S_H_PLANCK,
  S_NU0,
  S_KIRCHHOFF,
  // camera position (spatial part) and length unit
  S_CAM_X1,
  S_CAM_X2,
  S_CAM_X3,
  S_X_UNIT,
  S_COUNT
};

}  // namespace bl
