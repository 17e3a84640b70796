// C interface of the fused formula-model kernel (formula_kernel.cuh) and
// its rk4 and rk2 instantiations at one frequency without tangents. This
// unit is built without multiply-add contraction (-fmad=false): each
// operation then rounds as the plain PyTorch version's one-op-per-launch
// arithmetic does, and chaotic photon-ring rays, which amplify a one-ulp
// difference to 1e-7 in I_nu, keep float64 rk4/rk2 within rtol 1e-9 of it
// with identical flags and n_samples, and float32 rk4/rk2 inside the
// statistical gate.

#include "formula_kernel.cuh"

namespace {

// The instantiation a launch takes, by its type, integrator, frequency
// count and tangent mask.
cudaError_t dispatch(int dtype_code, int integrator, const bl::LaunchArgs& a) {
  const bool dp = integrator == bl::INTEGRATOR_DP;
  if (a.diff_mask != 0u) {
    return dp ? bl::launch_tangent_dp(dtype_code, a)
              : bl::launch_tangent_rk(dtype_code, integrator, a);
  }
  if (a.nf > 1) {
    return dp ? bl::launch_multi_dp(dtype_code, a)
              : bl::launch_multi_rk(dtype_code, integrator, a);
  }
  return dp ? bl::launch_dp(dtype_code, a) : bl::launch_rk<1, false>(dtype_code, integrator, a);
}

bool valid_shape(int nf, int diff_mask) {
  return nf >= 1 && nf <= bl::FORMULA_MAX_FREQUENCIES && diff_mask >= 0 &&
         diff_mask < (1 << bl::D_COUNT);
}

}  // namespace

// Plain C interface, bound with ctypes by ops/formula_kernel.py.
// dtype_code: 0 float32, 1 float64. integrator: 0 dp, 1 rk4, 2 rk2.
// nf: 1..FORMULA_MAX_FREQUENCIES frequencies. consts: a host pointer to
// the launch constants (FormulaLaunchConsts of the instantiation's
// frequency bucket, consts_bytes long), copied into the kernel parameter.
// diff_mask: the DiffParam bits carrying tangents (0: none); theta then
// holds one value per set bit, in the rays' type, and d_i_nu receives
// (nd, n_rays, ld) values. i_nu receives (n_rays, ld) values, this
// launch's frequencies at columns [0, nf). next_slot: one uint64 counter
// in device memory, zero before the launch. grid: the
// number of blocks (at most blacklight_formula_resident_blocks').
// Launches on `stream`, does not synchronize, allocates nothing; returns
// the cudaError_t of the launch (0 on success).
extern "C" int blacklight_formula_launch(int dtype_code, int integrator, int nf,
                                         int diff_mask, const void* positions,
                                         const void* directions,
                                         const void* momentum_factors, const void* consts,
                                         long long consts_bytes, const void* theta,
                                         void* next_slot, int grid,
                                         void* i_nu, void* d_i_nu, int ld, void* flags,
                                         void* n_samples, long long n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  if (!valid_shape(nf, diff_mask) || ld < nf) return static_cast<int>(cudaErrorInvalidValue);
  const bl::LaunchArgs a{positions,
                         directions,
                         momentum_factors,
                         consts,
                         consts_bytes,
                         theta,
                         nf,
                         static_cast<unsigned>(diff_mask),
                         ld,
                         static_cast<unsigned long long*>(next_slot),
                         grid,
                         i_nu,
                         d_i_nu,
                         static_cast<int*>(flags),
                         static_cast<int*>(n_samples),
                         n_rays,
                         static_cast<cudaStream_t>(stream),
                         nullptr};
  return static_cast<int>(dispatch(dtype_code, integrator, a));
}

// How many blocks of the instantiation a launch with these arguments takes
// the current card holds at once: blocks per SM times SMs, in *blocks.
extern "C" int blacklight_formula_resident_blocks(int dtype_code, int integrator, int nf,
                                                  int diff_mask, int* blocks) {
  if (!valid_shape(nf, diff_mask)) return static_cast<int>(cudaErrorInvalidValue);
  bl::LaunchArgs a{};
  a.nf = nf;
  a.diff_mask = static_cast<unsigned>(diff_mask);
  a.resident = blocks;
  return static_cast<int>(dispatch(dtype_code, integrator, a));
}

// sizeof(FormulaLaunchConsts) of a frequency bucket (1 or
// FORMULA_MAX_FREQUENCIES) in float (dtype_code 0) or double (1); -1
// otherwise.
extern "C" long long blacklight_formula_consts_bytes(int dtype_code, int bucket) {
  if (bucket == 1) {
    if (dtype_code == 0) return sizeof(bl::FormulaLaunchConsts<float, 1>);
    if (dtype_code == 1) return sizeof(bl::FormulaLaunchConsts<double, 1>);
  } else if (bucket == bl::FORMULA_MAX_FREQUENCIES) {
    if (dtype_code == 0) {
      return sizeof(bl::FormulaLaunchConsts<float, bl::FORMULA_MAX_FREQUENCIES>);
    }
    if (dtype_code == 1) {
      return sizeof(bl::FormulaLaunchConsts<double, bl::FORMULA_MAX_FREQUENCIES>);
    }
  }
  return -1;
}

extern "C" int blacklight_formula_param_count() { return bl::P_COUNT; }

extern "C" int blacklight_formula_frequency_param_count() { return bl::PF_COUNT; }

extern "C" int blacklight_formula_max_frequencies() { return bl::FORMULA_MAX_FREQUENCIES; }

extern "C" int blacklight_formula_threads() { return bl::THREADS; }

extern "C" const char* blacklight_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
