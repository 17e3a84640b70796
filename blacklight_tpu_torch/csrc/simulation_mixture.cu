// C interface of the simulation kernel of the thermal, power-law and kappa
// populations summed (simulation_kernel.cuh simulation_mixture_kernel,
// POP_MIXTURE) and its rk4 and rk2 instantiations on one block. The dp and
// mesh-block instantiations are in simulation_mixture_dp.cu,
// simulation_mixture_blocks.cu and simulation_mixture_blocks_dp.cu, units of
// their own so that nvcc builds them side by side and the thermal units
// stay as they were. Built without multiply-add contraction, as
// simulation_kernel.cu.

#include "simulation_kernel.cuh"

namespace bl {

template <typename T>
cudaError_t launch_simulation_mixture_rk(int integrator, const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_nf<T, INTEGRATOR_RK4, SAMPLE_SINGLE, POP_MIXTURE>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_nf<T, INTEGRATOR_RK2, SAMPLE_SINGLE, POP_MIXTURE>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl

namespace {

cudaError_t dispatch_mixture(int dtype_code, int integrator, const bl::SimLaunchArgs& a) {
  if (a.nf < 1 || a.nf > bl::MAX_FREQUENCIES) return cudaErrorInvalidValue;
  if (a.grid.mode == bl::SAMPLE_FMKS) {
    return bl::launch_simulation_mixture_fmks(dtype_code, integrator, a);
  }
  if (bl::is_cks_mode(a.grid.mode)) {
    return bl::launch_simulation_mixture_cks(dtype_code, integrator, a);
  }
  if (a.grid.mode != bl::SAMPLE_SINGLE) {
    if (integrator == bl::INTEGRATOR_DP) {
      return bl::launch_simulation_mixture_dp_blocks(dtype_code, a);
    }
    return bl::launch_simulation_mixture_rk_blocks(dtype_code, integrator, a);
  }
  if (integrator == bl::INTEGRATOR_DP) return bl::launch_simulation_mixture_dp(dtype_code, a);
  if (dtype_code == 0) return bl::launch_simulation_mixture_rk<float>(integrator, a);
  if (dtype_code == 1) return bl::launch_simulation_mixture_rk<double>(integrator, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes by ops/simulation_kernel.py: the
// arguments of blacklight_simulation_launch (simulation_kernel.cu), with
// consts a SimMixLaunchConsts of the frequency bucket (the launch
// constants, then the MixtureParam values, rounded to the rays' type).
extern "C" int blacklight_simulation_mixture_launch(
    int dtype_code, int integrator, int nf, const void* positions, const void* directions,
    const void* momentum_factors, const void* consts, long long consts_bytes, const void* table,
    const void* coords, const void* guides, const void* axes, int n_i, int n_j, int n_k,
    int mode, int nearest, int n_b, const void* bounds, const void* amr, const void* parity,
    const void* map, const void* kappa, void* i_nu, void* flags, void* n_samples, long long n_rays,
    void* stream) {
  if (n_rays <= 0) return 0;
  const bl::SimGridArgs grid{static_cast<const float*>(table),
                             coords,
                             static_cast<const int*>(guides),
                             static_cast<const double*>(axes),
                             n_i,
                             n_j,
                             n_k,
                             mode,
                             nearest != 0,
                             n_b,
                             bounds,
                             static_cast<const int*>(amr),
                             static_cast<const int*>(parity),
                             map,
                             static_cast<const float*>(kappa)};
  if (!grid.valid()) return static_cast<int>(cudaErrorInvalidValue);
  const bl::SimLaunchArgs a{positions,
                            directions,
                            momentum_factors,
                            consts,
                            consts_bytes,
                            nf,
                            grid,
                            i_nu,
                            static_cast<int*>(flags),
                            static_cast<int*>(n_samples),
                            n_rays,
                            static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_mixture(dtype_code, integrator, a));
}

// sizeof(SimMixLaunchConsts) of a frequency bucket (1 or MAX_FREQUENCIES)
// in float (dtype_code 0) or double (1); -1 otherwise.
extern "C" long long blacklight_simulation_mixture_consts_bytes(int dtype_code, int bucket) {
  if (bucket == 1) {
    if (dtype_code == 0) return sizeof(bl::SimMixLaunchConsts<float, 1>);
    if (dtype_code == 1) return sizeof(bl::SimMixLaunchConsts<double, 1>);
  } else if (bucket == bl::MAX_FREQUENCIES) {
    if (dtype_code == 0) return sizeof(bl::SimMixLaunchConsts<float, bl::MAX_FREQUENCIES>);
    if (dtype_code == 1) return sizeof(bl::SimMixLaunchConsts<double, bl::MAX_FREQUENCIES>);
  }
  return -1;
}

extern "C" int blacklight_simulation_mixture_param_count() { return bl::M_COUNT; }
