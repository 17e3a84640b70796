// C interface of the fused formula-model kernel (formula_kernel.cuh) and
// its rk4 and rk2 instantiations at one frequency without tangents. This
// unit is built without multiply-add contraction (-fmad=false): each
// operation then rounds as the plain PyTorch version's one-op-per-launch
// arithmetic does, and chaotic photon-ring rays, which amplify a one-ulp
// difference to 1e-7 in I_nu, keep float64 rk4/rk2 within rtol 1e-9 of it
// with identical flags and n_samples, and float32 rk4/rk2 inside the
// statistical gate.

#include "formula_kernel.cuh"

// Plain C interface, bound with ctypes by ops/formula_kernel.py.
// dtype_code: 0 float32, 1 float64. integrator: 0 dp, 1 rk4, 2 rk2.
// nf: 1..FORMULA_MAX_FREQUENCIES frequencies, whose blocks follow the fixed
// block of params. diff_mask: the DiffParam bits carrying tangents (0:
// none); theta then holds one value per set bit, in the rays' type, and
// d_i_nu receives (nd, n_rays, ld) values. i_nu receives (n_rays, ld)
// values, this launch's frequencies at columns [0, nf).
// Launches on `stream`, does not synchronize, allocates nothing; returns
// the cudaError_t of the launch (0 on success).
extern "C" int blacklight_formula_launch(int dtype_code, int integrator, int nf,
                                         int diff_mask, const void* positions,
                                         const void* directions,
                                         const void* momentum_factors, const void* params,
                                         const void* theta, void* i_nu, void* d_i_nu, int ld,
                                         void* flags, void* n_samples, long long n_rays,
                                         void* stream) {
  if (n_rays <= 0) return 0;
  if (nf < 1 || nf > bl::FORMULA_MAX_FREQUENCIES || ld < nf || diff_mask < 0 ||
      diff_mask >= (1 << bl::D_COUNT)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bl::LaunchArgs a{positions,
                         directions,
                         momentum_factors,
                         static_cast<const double*>(params),
                         theta,
                         nf,
                         static_cast<unsigned>(diff_mask),
                         ld,
                         i_nu,
                         d_i_nu,
                         static_cast<int*>(flags),
                         static_cast<int*>(n_samples),
                         n_rays,
                         static_cast<cudaStream_t>(stream)};
  const bool dp = integrator == bl::INTEGRATOR_DP;
  cudaError_t err;
  if (diff_mask != 0) {
    err = dp ? bl::launch_tangent_dp(dtype_code, a)
             : bl::launch_tangent_rk(dtype_code, integrator, a);
  } else if (nf > 1) {
    err = dp ? bl::launch_multi_dp(dtype_code, a)
             : bl::launch_multi_rk(dtype_code, integrator, a);
  } else {
    err = dp ? bl::launch_dp(dtype_code, a) : bl::launch_rk<1, false>(dtype_code, integrator, a);
  }
  return static_cast<int>(err);
}

extern "C" int blacklight_formula_param_count() { return bl::P_COUNT; }

extern "C" int blacklight_formula_frequency_param_count() { return bl::PF_COUNT; }

extern "C" int blacklight_formula_max_frequencies() { return bl::FORMULA_MAX_FREQUENCIES; }

extern "C" const char* blacklight_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
