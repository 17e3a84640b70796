// C interface of the phase kernel of the mixture population
// (simulation_kernel.cuh simulation_phase_mixture_kernel, POP_MIXTURE) and
// its rk4 and rk2 instantiations on one block in float and double; the
// mesh-block ones are in simulation_phase_mixture_blocks.cu. Built without
// multiply-add contraction, as simulation_mixture.cu: a phased render of
// the mixture gives its monolithic kernel's image bit for bit.

#include "simulation_kernel.cuh"

namespace bl {

template <typename T>
cudaError_t launch_simulation_phase_mixture_rk(int integrator, const SimPhaseArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_phase_nf<T, INTEGRATOR_RK4, SAMPLE_SINGLE, POP_MIXTURE>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_phase_nf<T, INTEGRATOR_RK2, SAMPLE_SINGLE, POP_MIXTURE>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl

namespace {

cudaError_t dispatch_phase_mixture(int dtype_code, int integrator, const bl::SimPhaseArgs& a) {
  if (a.nf < 1 || a.nf > bl::MAX_FREQUENCIES) return cudaErrorInvalidValue;
  if (a.grid.mode == bl::SAMPLE_FMKS) {
    return bl::launch_simulation_phase_mixture_fmks(dtype_code, integrator, a);
  }
  if (bl::is_cks_mode(a.grid.mode)) {
    return bl::launch_simulation_phase_mixture_cks(dtype_code, integrator, a);
  }
  if (a.grid.mode != bl::SAMPLE_SINGLE) {
    return bl::launch_simulation_phase_mixture_blocks(dtype_code, integrator, a);
  }
  if (dtype_code == 0) return bl::launch_simulation_phase_mixture_rk<float>(integrator, a);
  if (dtype_code == 1) return bl::launch_simulation_phase_mixture_rk<double>(integrator, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes by ops/simulation_kernel.py: the
// arguments of blacklight_simulation_phase_launch (simulation_phase.cu),
// with consts a SimMixLaunchConsts.
extern "C" int blacklight_simulation_phase_mixture_launch(
    int dtype_code, int integrator, int nf, const void* index, long long n_live, int n_base,
    int phase_steps, int write_state, const void* directions, const void* momentum_factors,
    const void* consts, long long consts_bytes, const void* table, const void* coords,
    const void* guides, const void* axes, int n_i, int n_j, int n_k, int mode, int nearest,
    int n_b, const void* bounds, const void* amr, const void* parity, const void* map,
    const void* kappa, void* y,
    void* r_mid_prev, void* n_samp, void* masks, void* intensity, void* tau, void* bad,
    long long n_rays, void* stream) {
  if (n_live <= 0) return 0;
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
  if (!grid.valid() || phase_steps < 1 || n_live > n_rays) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bl::SimPhaseArgs a{static_cast<const int*>(index),
                           n_live,
                           n_base,
                           phase_steps,
                           write_state != 0,
                           directions,
                           momentum_factors,
                           consts,
                           consts_bytes,
                           nf,
                           grid,
                           y,
                           r_mid_prev,
                           static_cast<int*>(n_samp),
                           static_cast<int*>(masks),
                           intensity,
                           tau,
                           static_cast<int*>(bad),
                           n_rays,
                           static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_phase_mixture(dtype_code, integrator, a));
}
