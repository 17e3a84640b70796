// Index order of the float64 parameter vector the formula kernel reads:
// the fixed block (FormulaParam), then one block per frequency of the
// launch (FrequencyParam), frequency f at P_COUNT + f * PF_COUNT.
//
// The host (blacklight_tpu_torch/ops/formula_kernel.py, PARAM_NAMES and
// FREQUENCY_PARAM_NAMES) fills it in this order, with every derived
// constant computed in float64; tests/test_torch_formula_kernel.py checks
// that the orders agree. Flags are stored as 0.0 / 1.0 and integers as
// exact doubles.
#pragma once

namespace bl {

enum FormulaParam : int {
  // geodesic (GeodesicParams; Kerr-Schild scalars folded on the host)
  P_SPIN,
  P_A2,
  P_TWO_SPIN,
  P_TWO_A2,
  P_THREE_A2,
  P_TWO_MASS,
  P_FLAT,
  P_RAY_STEP,
  P_CAMERA_R,
  P_R_TERMINATE,
  P_R_HORIZON,
  P_TOL_ABS,
  P_TOL_REL,
  P_MAX_STEPS,
  P_MAX_RETRIES,
  P_FALLBACK_NAN,
  // formula model (FormulaParams)
  P_F_BH_A,
  P_F_A2,
  P_F_TWO_A,
  P_F_TWO_M,
  P_F_NEG_TWO_M_A,
  P_F_CAMERA_R,
  P_F_L0,
  P_F_ONE_PLUS_Q,
  P_F_INV_R0_SQ,
  P_F_H_SQ,
  P_F_INV_NUP,
  P_F_A_PARAM,
  P_F_CN0,
  P_EJ,
  P_EJ_IS_INT,
  P_EJ_SIGN,
  P_EA,
  P_EA_IS_INT,
  P_EA_SIGN,
  // geometric cuts; an _ON flag or a sign (-1, 0, +1) decided on the host
  // from the float64 value, then the value (a magnitude for the signs)
  P_CUT_NEAR,
  P_CUT_FAR,
  P_CUT_IN_ON,
  P_CUT_IN,
  P_CUT_OUT_ON,
  P_CUT_OUT,
  P_CUT_MID_THETA_SIGN,
  P_CUT_MID_THETA,
  P_CUT_MID_Z_SIGN,
  P_CUT_MID_Z,
  P_CUT_PLANE,
  P_PLANE_OX,
  P_PLANE_OY,
  P_PLANE_OZ,
  P_PLANE_NX,
  P_PLANE_NY,
  P_PLANE_NZ,
  // camera position
  P_CAM_X0,
  P_CAM_X1,
  P_CAM_X2,
  P_CAM_X3,
  P_COUNT
};

// The block of one frequency: nu, the unit length over nu and the image
// scale exp(log_j_scale) nu^3.
enum FrequencyParam : int {
  PF_NU,
  PF_X_UNIT_OVER_NU,
  PF_I_SCALE,
  PF_COUNT
};

}  // namespace bl
