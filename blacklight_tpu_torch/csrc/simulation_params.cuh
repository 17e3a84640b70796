// Index order of the float64 parameter vector the simulation kernel reads.
//
// The host (blacklight_tpu_torch/ops/simulation_kernel.py, PARAM_NAMES)
// fills it in this order, with every derived constant folded in float64
// as the JAX package folds it in Python before it meets an array;
// tests/test_torch_simulation_pipeline.py checks that the two orders agree.
// Flags are stored as 0.0 / 1.0 and integers as exact doubles.
//
// MixtureParam indexes the constants of the power-law and kappa
// populations, which a launch of a mixture instantiation carries after
// these (ops/simulation_kernel.py MIX_PARAM_NAMES, mixture_params): the
// thermal instantiations read none of them.
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

// The power-law and kappa populations (models/synchrotron.py
// powerlaw_constants, kappa_constants, powerlaw_coefficients,
// kappa_coefficients) and the code_kappa temperature
// (code_kappa_temperature), each constant folded in float64 on the host as
// the Python expressions fold it before it meets a tensor.
enum MixtureParam : int {
  // which populations the sum holds (fraction != 0), and e^2 / (m_e c)
  M_THERMAL_ON,
  M_POWER_ON,
  M_KAPPA_ON,
  M_KA,
  // power law: the fraction, the exponents of nu / (nu_c sin), the
  // constants, frac * rho, gamma_min^2 and the exponent of var_e3
  M_PL_FRAC,
  M_PL_J_EXP,
  M_PL_A_EXP,
  M_PL_JJ,
  M_PL_AA,
  M_PL_JJ_Q,
  M_PL_JJ_V,
  M_PL_AA_Q,
  M_PL_AA_V,
  M_PL_FRAC_RHO,
  M_PL_RHO_Q,
  M_PL_RHO_V,
  M_PL_GMIN2,
  M_PL_E3_EXP,
  // kappa: the fraction, -frac, 2 frac, w, kappa, the exponents of xx
  M_KP_FRAC,
  M_KP_NEG_FRAC,
  M_KP_TWO_FRAC,
  M_KP_W,
  M_KP_KAPPA,
  M_KP_J_EXP,
  M_KP_A_EXP,
  // the low- and high-frequency constants of each bridge
  M_KP_JJ_LOW,
  M_KP_JJ_HIGH,
  M_KP_AA_LOW,
  M_KP_AA_HIGH,
  M_KP_AA_HIGH_I,
  M_KP_JJ_LOW_Q,
  M_KP_JJ_HIGH_Q,
  M_KP_JJ_LOW_V,
  M_KP_JJ_HIGH_V,
  M_KP_AA_LOW_Q,
  M_KP_AA_HIGH_Q,
  M_KP_AA_LOW_V,
  M_KP_AA_HIGH_V,
  // each bridge's exponent x and -1 / x: j_I, j_Q, j_V, alpha_I,
  // alpha_Q, alpha_V
  M_KP_X_JI,
  M_KP_NX_JI,
  M_KP_X_JQ,
  M_KP_NX_JQ,
  M_KP_X_JV,
  M_KP_NX_JV,
  M_KP_X_AI,
  M_KP_NX_AI,
  M_KP_X_AQ,
  M_KP_NX_AQ,
  M_KP_X_AV,
  M_KP_NX_AV,
  // rotativities: K0 / K2 at 1 / w, the bracket blend's fr and 1 - fr,
  // the low and high brackets' rho_Q (a..e) and rho_V (a, b)
  M_KP_RHO_V,
  M_KP_RHO_FRAC,
  M_KP_RHO_1M_FRAC,
  M_KP_QL_A,
  M_KP_QL_B,
  M_KP_QL_C,
  M_KP_QL_D,
  M_KP_QL_E,
  M_KP_QH_A,
  M_KP_QH_B,
  M_KP_QH_C,
  M_KP_QH_D,
  M_KP_QH_E,
  M_KP_VL_A,
  M_KP_VL_B,
  M_KP_VH_A,
  M_KP_VH_B,
  // plasma_model = code_kappa: the temperature from the sampled electron
  // entropy (its flag; m_e, mu_e m_p and c^2 of rho_e = rho m_e /
  // (mu_e m_p) and kb_tt_e = theta_e m_e c^2), and the entropy of
  // off-grid samples
  M_CODE_KAPPA,
  M_CK_ME,
  M_CK_MU_E_MP,
  M_CK_C2,
  M_FALLBACK_KAPPA,
  M_COUNT
};

}  // namespace bl
