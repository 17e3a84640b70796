// C interface of the phase kernel of phased dispatch
// (simulation_kernel.cuh simulation_phase_kernel) and its rk4 and rk2
// instantiations in float and double, at one frequency (accumulators in
// registers) and up to MAX_FREQUENCIES (a local array). Built without
// multiply-add contraction (-fmad=false), as simulation_kernel.cu is: a
// phased render then gives the monolithic kernel's image bit for bit.

#include "simulation_kernel.cuh"

namespace bl {

template <typename T>
cudaError_t launch_simulation_phase_rk(int integrator, const SimPhaseArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_phase_nf<T, INTEGRATOR_RK4>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_phase_nf<T, INTEGRATOR_RK2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl

namespace {

// The instantiation a phase launch takes, by its type, integrator and
// sampling mode (and a.nf).
cudaError_t dispatch_phase(int dtype_code, int integrator, const bl::SimPhaseArgs& a) {
  if (a.nf < 1 || a.nf > bl::MAX_FREQUENCIES) return cudaErrorInvalidValue;
  if (a.grid.mode == bl::SAMPLE_FMKS) {
    return bl::launch_simulation_phase_fmks(dtype_code, integrator, a);
  }
  if (bl::is_cks_mode(a.grid.mode)) {
    return bl::launch_simulation_phase_cks(dtype_code, integrator, a);
  }
  if (a.grid.mode != bl::SAMPLE_SINGLE) {
    return bl::launch_simulation_phase_blocks(dtype_code, integrator, a);
  }
  if (dtype_code == 0) return bl::launch_simulation_phase_rk<float>(integrator, a);
  if (dtype_code == 1) return bl::launch_simulation_phase_rk<double>(integrator, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes by ops/simulation_kernel.py.
// dtype_code: 0 float32, 1 float64. integrator: 1 rk4, 2 rk2 (dp is
// refused). index holds n_live int32 ray indices below n_rays; directions
// (n_rays, 4) and momentum_factors (n_rays,) are the bundle's; consts and
// the snapshot (table, coords, guides, axes, n_i, n_j, n_k, mode,
// nearest, n_b, bounds, amr, parity, map) as blacklight_simulation_launch's.
// The carried state: y (7, n_rays), r_mid_prev, n_samp (int32), masks
// (int32) and bad (int32), each (n_rays,), and intensity and tau (nf,
// n_rays), in the rays' type where not named. Runs the steps [n_base,
// n_base + phase_steps) of every listed ray and writes its transfer sums
// and bad bits back; with write_state
// also its RayState (a launch for a further block of frequencies of the
// same phase passes 0, so that every block starts from the same state).
// Launches on `stream`, does not synchronize, allocates nothing; returns
// the cudaError_t of the launch.
extern "C" int blacklight_simulation_phase_launch(
    int dtype_code, int integrator, int nf, const void* index, long long n_live, int n_base,
    int phase_steps, int write_state, const void* directions, const void* momentum_factors,
    const void* consts, long long consts_bytes, const void* table, const void* coords,
    const void* guides, const void* axes, int n_i, int n_j, int n_k, int mode, int nearest,
    int n_b, const void* bounds, const void* amr, const void* parity, const void* map, void* y,
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
                             map};
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
  return static_cast<int>(dispatch_phase(dtype_code, integrator, a));
}
