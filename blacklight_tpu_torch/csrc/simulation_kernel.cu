// C interface of the fused simulation-model kernel (simulation_kernel.cuh)
// and its rk4 and rk2 instantiations. Like formula_kernel.cu, this unit is
// built without multiply-add contraction (-fmad=false), so that each
// operation rounds as the plain PyTorch version's does and float64 rk4/rk2
// keep identical flags and n_samples with it.

#include "simulation_kernel.cuh"

namespace bl {

template <typename T>
cudaError_t launch_simulation_rk(int integrator, const SimLaunchArgs& a) {
  switch (integrator) {
    case INTEGRATOR_RK4:
      return launch_simulation_nf<T, INTEGRATOR_RK4>(a);
    case INTEGRATOR_RK2:
      return launch_simulation_nf<T, INTEGRATOR_RK2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bl

namespace {

// The instantiation a launch takes, by its type, integrator and sampling
// mode (and a.nf).
cudaError_t dispatch(int dtype_code, int integrator, const bl::SimLaunchArgs& a) {
  if (a.nf < 1 || a.nf > bl::MAX_FREQUENCIES) return cudaErrorInvalidValue;
  if (a.grid.mode == bl::SAMPLE_FMKS) return bl::launch_simulation_fmks(dtype_code, integrator, a);
  if (bl::is_cks_mode(a.grid.mode)) return bl::launch_simulation_cks(dtype_code, integrator, a);
  if (a.grid.mode != bl::SAMPLE_SINGLE) {
    if (integrator == bl::INTEGRATOR_DP) return bl::launch_simulation_dp_blocks(dtype_code, a);
    return bl::launch_simulation_rk_blocks(dtype_code, integrator, a);
  }
  if (integrator == bl::INTEGRATOR_DP) return bl::launch_simulation_dp(dtype_code, a);
  if (dtype_code == 0) return bl::launch_simulation_rk<float>(integrator, a);
  if (dtype_code == 1) return bl::launch_simulation_rk<double>(integrator, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes by ops/simulation_kernel.py.
// dtype_code: 0 float32, 1 float64. integrator: 0 dp, 1 rk4, 2 rk2.
// nf: 1..MAX_FREQUENCIES frequencies. consts: a host pointer to the launch
// constants (SimLaunchConsts of the instantiation's frequency bucket, 1 or
// MAX_FREQUENCIES, consts_bytes long), copied into the kernel parameter.
// table is (n_b, n_k, n_j, n_i, 8) float32; coords holds x1f, x1v, x2f,
// x2v, x3f, x3v ((n_b, n + 1) and (n_b, n) each) in the rays' type; guides
// the three axes' guides (int32) and axes, a host array, their lo, hi,
// scale and bins (4 doubles an axis). mode: the sampling mode
// (sim_sample.cuh SAMPLE_*: 0 one block, 1 many blocks or the nearest
// cell, 2 exact interblock, 3 one FMKS block, 4 and 5 modes 1 and 2 on a
// CKS grid); nearest: 1 for the nearest cell (modes 1, 3 and 4); bounds
// (n_b, 6) in the rays' type (modes 1, 2, 4 and 5); amr (n_b, 27, 8, 5)
// and parity (n_b, 3) int32 (modes 2 and 5); map the FMKS
// table (2, n2m, n1m) in the rays' type, with FMKS_MAP_VALUES more values
// in axes after the axes' (mode 3). i_nu receives (n_rays, nf) values.
// Launches on `stream`, does not synchronize, allocates nothing; returns
// the cudaError_t of the launch.
extern "C" int blacklight_simulation_launch(
    int dtype_code, int integrator, int nf, const void* positions, const void* directions,
    const void* momentum_factors, const void* consts, long long consts_bytes, const void* table,
    const void* coords, const void* guides, const void* axes, int n_i, int n_j, int n_k,
    int mode, int nearest, int n_b, const void* bounds, const void* amr, const void* parity,
    const void* map, void* i_nu, void* flags, void* n_samples, long long n_rays, void* stream) {
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
                             map};
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
  return static_cast<int>(dispatch(dtype_code, integrator, a));
}

// sizeof(SimLaunchConsts) of a frequency bucket (1 or MAX_FREQUENCIES) in
// float (dtype_code 0) or double (1); -1 otherwise.
extern "C" long long blacklight_simulation_consts_bytes(int dtype_code, int bucket) {
  if (bucket == 1) {
    if (dtype_code == 0) return sizeof(bl::SimLaunchConsts<float, 1>);
    if (dtype_code == 1) return sizeof(bl::SimLaunchConsts<double, 1>);
  } else if (bucket == bl::MAX_FREQUENCIES) {
    if (dtype_code == 0) return sizeof(bl::SimLaunchConsts<float, bl::MAX_FREQUENCIES>);
    if (dtype_code == 1) return sizeof(bl::SimLaunchConsts<double, bl::MAX_FREQUENCIES>);
  }
  return -1;
}

extern "C" int blacklight_simulation_param_count() { return bl::S_COUNT; }

extern "C" int blacklight_simulation_max_frequencies() { return bl::MAX_FREQUENCIES; }

extern "C" int blacklight_simulation_guide_axis_values() { return bl::GUIDE_AXIS_VALUES; }

extern "C" int blacklight_simulation_amr_table_fields() { return bl::AMR_TABLE_FIELDS; }

extern "C" int blacklight_simulation_fmks_map_values() { return bl::FMKS_MAP_VALUES; }
