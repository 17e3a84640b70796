// What the simulation-model kernels do at one stored sample before the
// transfer: CKS -> SKS (none on a CKS grid), the cell search and trilinear
// blend of the GRMHD table, the fluid state, the value cuts, u and b in
// CKS, the pitch angle and the thermal j_I / alpha_I, or their sum with the power-law and kappa
// populations' (a compile-time population, POP_THERMAL or POP_MIXTURE). The unpolarized kernel
// (simulation_kernel.cuh) and the polarized one (polarized_kernel.cuh)
// both call these, so the two cannot drift.
//
// The values follow the JAX package's exact (XLA) path in each type's
// forms: grid/sampling.py sample_grid, models/synchrotron.py fluid_state,
// value_cuts, pitch_angle and thermal_coefficients (ops/sks.py for the
// metric and the frame changes). Their plain PyTorch versions are
// blacklight_tpu_torch/grid/sampling.py and models/synchrotron.py; this
// file writes their operation forms (a scalar numerator s / t as
// (1 / t) * s, as PyTorch evaluates it).
#pragma once

#include "cuts.cuh"
#include "simulation_params.cuh"
#include "trace.cuh"

namespace bl {

constexpr double TWO_PI = 6.283185307179586;

// Floors and caps that depend on the working type (models/synchrotron.py
// :147-179, :254-268, :819-867; transfer/polarized_coupling.py _lims
// :246-260): float64 keeps the reference's literal forms, float32 the ones
// that keep single precision finite.
template <typename T>
struct TypeForms;
template <>
struct TypeForms<float> {
  static constexpr bool F64 = false;
  static __device__ __forceinline__ float div_floor() { return 1e-15f; }
  static __device__ __forceinline__ float pitch_floor() { return 1e-16f; }
  static __device__ __forceinline__ float sqrt_cut() { return 1e-24f; }
  static __device__ __forceinline__ float nu_s_floor() { return 1e-12f; }
  // polarized coupling: sqrt floor, cap on hyperbolic arguments, guard of
  // a reciprocal (|den| <= guard takes 1 / 1)
  static __device__ __forceinline__ float coupling_sqrt_floor() { return 1e-16f; }
  static __device__ __forceinline__ float coupling_exp_max() { return 80.0f; }
  static __device__ __forceinline__ float coupling_recip_guard() { return 1e-16f; }
  // the power-law and kappa populations: the floor of nu_c sin and
  // nu_kappa, the bridge's floor of its larger term
  static __device__ __forceinline__ float pop_floor() { return 1e-12f; }
  static __device__ __forceinline__ float bridge_floor() { return 1e-18f; }
};
template <>
struct TypeForms<double> {
  static constexpr bool F64 = true;
  static __device__ __forceinline__ double div_floor() { return 1e-30; }
  static __device__ __forceinline__ double pitch_floor() { return 1e-300; }
  static __device__ __forceinline__ double sqrt_cut() { return 1e-300; }
  static __device__ __forceinline__ double nu_s_floor() { return 1e-300; }
  static __device__ __forceinline__ double coupling_sqrt_floor() { return 1e-40; }
  static __device__ __forceinline__ double coupling_exp_max() { return 705.0; }
  static __device__ __forceinline__ double coupling_recip_guard() { return 0.0; }
  static __device__ __forceinline__ double pop_floor() { return 1e-300; }
  static __device__ __forceinline__ double bridge_floor() { return 1e-150; }
};

// Tag of SimConsts' constructor from launch constants the host already
// rounded to T (ops/simulation_kernel.py launch_consts).
struct RoundedConsts {};

// Constants of one launch, each rounded once to T: from the float64
// parameter vector in device memory (the polarized kernels), or from the
// simulation kernels' launch constants, which the compiler then reads as
// constant-bank operands where they are used. A value cut that is off is
// -inf (a minimum) or +inf (a maximum), which no value fails.
template <typename T>
struct SimConsts {
  CutConsts<T> cuts;
  T spin, a2, two_spin, camera_r, cam1, cam2, cam3, x_unit;
  bool fallback_nan, use_p;
  T d_unit, e_unit, b_unit, mu_mp, ne_div, rat_high, rat_low, kb_tot;
  T one_plus_ne_ni, ne_ni, gamma_m1, gamma_i_m1, ne_ni_over_gamma_e_m1, me_c2;
  T thermal_frac, e_charge, nu_c_div, two_ninths, var_a, var_b, h_planck, nu0,
      kirchhoff;
  T value_lo[7], value_hi[7];  // S_RHO_MIN..S_BETA_INV_MAX

  // The float64 vector: a value cut is on where its value is >= 0.0 (the
  // JAX package's test of the Python float).
  __device__ explicit SimConsts(const double* p) : cuts(p + S_CUT_NEAR) {
    set(p);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const double lo = p[S_RHO_MIN + 2 * q], hi = p[S_RHO_MIN + 2 * q + 1];
      value_lo[q] = lo >= 0.0 ? T(lo) : T(-INFINITY);
      value_hi[q] = hi >= 0.0 ? T(hi) : T(INFINITY);
    }
  }

  // Launch constants rounded to T, the cuts that are off already +-inf.
  __device__ SimConsts(const T* p, RoundedConsts) : cuts(p + S_CUT_NEAR) {
    set(p);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      value_lo[q] = p[S_RHO_MIN + 2 * q];
      value_hi[q] = p[S_RHO_MIN + 2 * q + 1];
    }
  }

 private:
  template <typename S>
  __device__ void set(const S* p) {
    spin = T(p[S_SPIN]);
    a2 = T(p[S_A2]);
    two_spin = T(p[S_TWO_SPIN]);
    camera_r = T(p[S_CAMERA_R]);
    cam1 = T(p[S_CAM_X1]);
    cam2 = T(p[S_CAM_X2]);
    cam3 = T(p[S_CAM_X3]);
    x_unit = T(p[S_X_UNIT]);
    fallback_nan = flag_at<T>(p, S_FALLBACK_NAN);
    use_p = flag_at<T>(p, S_USE_P);
    d_unit = T(p[S_D_UNIT]);
    e_unit = T(p[S_E_UNIT]);
    b_unit = T(p[S_B_UNIT]);
    mu_mp = T(p[S_MU_MP]);
    ne_div = T(p[S_NE_DIV]);
    rat_high = T(p[S_RAT_HIGH]);
    rat_low = T(p[S_RAT_LOW]);
    kb_tot = T(p[S_KB_TOT]);
    one_plus_ne_ni = T(p[S_ONE_PLUS_NE_NI]);
    ne_ni = T(p[S_NE_NI]);
    gamma_m1 = T(p[S_GAMMA_M1]);
    gamma_i_m1 = T(p[S_GAMMA_I_M1]);
    ne_ni_over_gamma_e_m1 = T(p[S_NE_NI_OVER_GAMMA_E_M1]);
    me_c2 = T(p[S_ME_C2]);
    thermal_frac = T(p[S_THERMAL_FRAC]);
    e_charge = T(p[S_E_CHARGE]);
    nu_c_div = T(p[S_NU_C_DIV]);
    two_ninths = T(p[S_TWO_NINTHS]);
    var_a = T(p[S_VAR_A]);
    var_b = T(p[S_VAR_B]);
    h_planck = T(p[S_H_PLANCK]);
    nu0 = T(p[S_NU0]);
    kirchhoff = T(p[S_KIRCHHOFF]);
  }
};

// One axis of the snapshot: its n + 1 faces (non-decreasing, checked on
// the host) and n centres in device memory, and the guide that starts the
// cell search near its answer: `bins` uniform bins over [lo, hi] = [xf[0],
// xf[n]], bin b holding the count of faces below its lower edge
// (ops/simulation_kernel.py axis_bins, axis_guide). lo, hi and scale = bins / (hi -
// lo) are kernel parameters, read from the constant bank.
template <typename T>
struct GridAxis {
  const T* __restrict__ xf;
  const T* __restrict__ xv;
  const int* __restrict__ guide;
  T lo, hi, scale;
  int n, bins;
};

// The kernels' view of the snapshot: a (n_k, n_j, n_i, 8) float32 table
// (rho, pgas, uu1..3, bb1..3 of a cell side by side, two 16-byte loads) and
// the r, theta and phi axes (i, j, k) in T.
template <typename T>
struct GridView {
  const float4* __restrict__ table;
  GridAxis<T> ax[3];
};

// The values of one axis in a grid launch's host array `axes` (4 doubles
// an axis: lo, hi, scale, bins; GUIDE_AXIS_VALUES of KernelGrid.axes).
constexpr int GUIDE_AXIS_VALUES = 4;

// The view of a (n_b, n_k, n_j, n_i, 8) float32 table, the concatenated
// coordinates x1f, x1v, x2f, x2v, x3f, x3v ((n_b, n + 1) faces and
// (n_b, n) centres an axis), the concatenated guides of the three axes and
// their host array `axes`.
template <typename T>
GridView<T> make_grid_view(const float* table, const void* coords_, const int* guides,
                           const double* axes, int n_i, int n_j, int n_k, int n_b = 1) {
  const T* coords = static_cast<const T*>(coords_);
  GridView<T> grid;
  grid.table = reinterpret_cast<const float4*>(table);
  const int n[3] = {n_i, n_j, n_k};
  for (int a = 0; a < 3; ++a) {
    GridAxis<T>& ax = grid.ax[a];
    const double* v = axes + GUIDE_AXIS_VALUES * a;
    ax.xf = coords;
    ax.xv = coords + static_cast<long long>(n_b) * (n[a] + 1);
    ax.guide = guides;
    ax.lo = T(v[0]);
    ax.hi = T(v[1]);
    ax.scale = T(v[2]);
    ax.n = n[a];
    ax.bins = static_cast<int>(v[3]);
    coords += static_cast<long long>(n_b) * (2 * n[a] + 1);
    guides += ax.bins;
  }
  return grid;
}

// The count of faces below x, which is what a binary search over the faces
// gives (x NaN: 0): walked up or down face by face from `hint` (the count
// at the ray's previous sample), or, with no hint (-1), from the count
// below x's guide bin; the result becomes the hint. Faces are
// non-decreasing, so `xf[q] < x` holds for a prefix of them and the walk
// ends at its end from any start: the start only decides how far it
// walks.
template <typename T>
__device__ __forceinline__ int faces_below(const GridAxis<T>& a, T x, int& hint) {
  int q = hint;
  if (q < 0) {
    const T t = (x - a.lo) * a.scale;
    const int bin = t > T(0) ? (t < T(a.bins - 1) ? static_cast<int>(t) : a.bins - 1) : 0;
    q = __ldg(a.guide + bin);
  }
  if (q <= a.n && __ldg(a.xf + q) < x) {
    do {
      ++q;
    } while (q <= a.n && __ldg(a.xf + q) < x);
  } else {
    while (q > 0 && !(__ldg(a.xf + q - 1) < x)) --q;
  }
  hint = q;
  return q;
}

// Cell location along one axis (grid/sampling.py _locate :54-87): i is the
// count of faces below x, less one, clamped to the cells; the anchor i_m
// backs off by one when x lies before the centre of cell i (except at the
// block edges), and the fraction f may leave [0, 1] near the edges.
template <typename T>
__device__ __forceinline__ void locate(const GridAxis<T>& a, T x, int& i_m, T& f,
                                       int& hint) {
  const int n = a.n;
  const int i = min(max(faces_below(a, x, hint) - 1, 0), n - 1);
  const T xv_i = __ldg(a.xv + i);
  const bool use_i = (i == 0) || (i != n - 1 && x >= xv_i);
  i_m = use_i ? i : i - 1;
  // n >= 2, so cell i + 1 exists when use_i and cell i - 1 when not
  const T x_lo = use_i ? xv_i : __ldg(a.xv + i - 1);
  const T x_hi = use_i ? __ldg(a.xv + i + 1) : xv_i;
  f = (x - x_lo) / (x_hi - x_lo);
}

__device__ __forceinline__ float prim_at(const float4& a, const float4& b, int v) {
  switch (v) {
    case 0: return a.x;
    case 1: return a.y;
    case 2: return a.z;
    case 3: return a.w;
    case 4: return b.x;
    case 5: return b.y;
    case 6: return b.z;
    default: return b.w;
  }
}

// A sample point in CKS and SKS (ops/sks.py cks_to_sks); phi in [0, 2 pi),
// ph_raw before the wrap.
template <typename T>
struct SksPoint {
  T x, y, z, r2, r, th, ph_raw, ph;
};

// The point of radius q (kerr.cuh ks_radius_parts: the step hands over the
// parts it computed at the sample point, the same expression on the same
// values as here).
template <typename T>
__device__ __forceinline__ SksPoint<T> cks_to_sks(const SimConsts<T>& c, T x, T y, T z,
                                                  const KsRadius<T>& q) {
  SksPoint<T> p;
  p.x = x;
  p.y = y;
  p.z = z;
  p.r2 = q.r2;
  p.r = q.r;
  p.th = m_acos(jmin(jmax(z / p.r, T(-1)), T(1)));
  p.ph_raw = m_atan2(y, x) - m_atan((T(1) / p.r) * c.spin);
  T ph = p.ph_raw < T(0) ? p.ph_raw + T(TWO_PI) : p.ph_raw;
  p.ph = ph >= T(TWO_PI) ? ph - T(TWO_PI) : ph;
  return p;
}

// The Kerr-Schild radius at (x, y, z) where no step handed it over (the
// polarized derive kernel's samples).
template <typename T>
__device__ __forceinline__ KsRadius<T> sample_radius(const SimConsts<T>& c, T x, T y, T z) {
  KsRadius<T> q;
  q.rr2 = x * x + y * y + z * z;
  q.r2 = T(0.5) * (q.rr2 - c.a2 + m_hypot(q.rr2 - c.a2, c.two_spin * z));
  q.r = m_sqrt(q.r2);
  return q;
}

template <typename T>
__device__ __forceinline__ SksPoint<T> cks_to_sks(const SimConsts<T>& c, T x, T y, T z) {
  return cks_to_sks(c, x, y, z, sample_radius(c, x, y, z));
}

template <typename T>
__device__ __forceinline__ bool is_off_grid(const GridView<T>& grid, const SksPoint<T>& p) {
  return p.r < grid.ax[0].lo || p.r > grid.ax[0].hi || p.th < grid.ax[1].lo ||
         p.th > grid.ax[1].hi || p.ph < grid.ax[2].lo || p.ph > grid.ax[2].hi;
}

// Trilinear blend of the 8 corner cells (grid/sampling.py :284-371), the
// positivity repair of rho and pgas against the anchor cell (:225-226) and
// the reference's float32 storage of samples (:189); v in table order
// (rho, pgas, uu1..3, bb1..3). For a point on the grid; hint: each axis'
// face count at the ray's previous sample (-1: none), updated. With NV = 9
// (the mixture's kernels) v[8] is the electron entropy of plasma_model =
// code_kappa, blended from the cell table `kappa` (n_k, n_j, n_i) with the
// same corners and weights and repaired against the anchor as rho is (0
// where the launch has no such table).
template <typename T, int NV>
__device__ __forceinline__ void sample_cell(const GridView<T>& grid, const SksPoint<T>& p,
                                            T (&v)[NV], int (&hint)[3],
                                            const float* __restrict__ kappa = nullptr) {
  const int n_i = grid.ax[0].n, n_j = grid.ax[1].n, n_k = grid.ax[2].n;
  int i_m, j_m, k_m;
  T f_i, f_j, f_k;
  locate(grid.ax[0], p.r, i_m, f_i, hint[0]);
  locate(grid.ax[1], p.th, j_m, f_j, hint[1]);
  locate(grid.ax[2], p.ph, k_m, f_k, hint[2]);
  i_m = min(max(i_m, 0), n_i - 2);
  j_m = min(max(j_m, 0), n_j - 2);
  k_m = min(max(k_m, 0), n_k - 2);
  const T w[8] = {(T(1) - f_k) * (T(1) - f_j) * (T(1) - f_i),
                  (T(1) - f_k) * (T(1) - f_j) * f_i,
                  (T(1) - f_k) * f_j * (T(1) - f_i),
                  (T(1) - f_k) * f_j * f_i,
                  f_k * (T(1) - f_j) * (T(1) - f_i),
                  f_k * (T(1) - f_j) * f_i,
                  f_k * f_j * (T(1) - f_i),
                  f_k * f_j * f_i};
  const long long anchor =
      (static_cast<long long>(k_m) * n_j + j_m) * static_cast<long long>(n_i) + i_m;
  float anchor_rho = 0.0f, anchor_pgas = 0.0f, anchor_kappa = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int dk = corner >> 2, dj = (corner >> 1) & 1, di = corner & 1;
    const long long cell =
        anchor + (static_cast<long long>(dk) * n_j + dj) * static_cast<long long>(n_i) + di;
    const float4 a = __ldg(grid.table + 2 * cell);
    const float4 b = __ldg(grid.table + 2 * cell + 1);
    if (corner == 0) {
      anchor_rho = a.x;
      anchor_pgas = a.y;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const T term = w[corner] * T(prim_at(a, b, q));
      v[q] = corner == 0 ? term : v[q] + term;
    }
    if constexpr (NV > 8) {
      const float k = kappa != nullptr ? __ldg(kappa + cell) : 0.0f;
      if (corner == 0) anchor_kappa = k;
      const T term = w[corner] * T(k);
      v[8] = corner == 0 ? term : v[8] + term;
    }
  }
  if (v[0] <= T(0)) v[0] = T(anchor_rho);
  if (v[1] <= T(0)) v[1] = T(anchor_pgas);
  if constexpr (NV > 8) {
    if (v[8] <= T(0)) v[8] = T(anchor_kappa);
  }
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = T(static_cast<float>(v[q]));
}

// ---------------------------------------------------------------------------
// Many mesh blocks (grid/sampling.py sample_sks): the modes of the
// sampler, fixed at compile time so that the single-block code above stays
// as it was. SAMPLE_SINGLE: one block, the guided walk and trilinear
// interpolation clamped to the block (sample_cell). SAMPLE_BLOCKS: the
// block search, then trilinear interpolation clamped to the block, or the
// nearest cell where the launch says so (BlockGridView::nearest; a
// one-block grid sampled at the nearest cell takes this mode too).
// SAMPLE_INTERBLOCK: the block search, then exact trilinear interpolation
// across block faces at the same, a coarser or a finer level, on the
// host's neighbour table (grid/amr.py). The functions of many blocks below
// keep their own face walk, anchor and blend (block_faces_below,
// locate_in_block, blend_cells): sharing them with faces_below, locate and
// sample_cell changes the single-block kernels' SASS.
constexpr int SAMPLE_SINGLE = 0;
constexpr int SAMPLE_BLOCKS = 1;
constexpr int SAMPLE_INTERBLOCK = 2;
// Values of a neighbour table entry (grid/amr.py TABLE_FIELDS): the block,
// the case and the three crossings.
constexpr int AMR_TABLE_FIELDS = 5;

// The table (n_b, n_k, n_j, n_i, 8) and each axis' faces (n_b, n + 1) and
// centres (n_b, n), block after block (cells; its axes' lo and hi bound
// every block's box, and their guides are not read), each block's box
// (bounds: r, theta, phi low and high faces, 6 values a block) and, under
// SAMPLE_INTERBLOCK, the neighbour table (n_b, 27, 8, 5) and the
// locations' parities (n_b, 3).
template <typename T>
struct BlockGridView {
  GridView<T> cells;
  const T* __restrict__ bounds;
  const int* __restrict__ amr;
  const int* __restrict__ parity;
  int n_b;
  bool nearest;
};

// The view a kernel of MODE takes.
template <typename T, int MODE>
struct SampleGridOf {
  using type = BlockGridView<T>;
};
template <typename T>
struct SampleGridOf<T, SAMPLE_SINGLE> {
  using type = GridView<T>;
};
template <typename T, int MODE>
using SampleGrid = typename SampleGridOf<T, MODE>::type;

// The block that holds the point (grid/sampling.py locate_anchor): the
// first in block order whose closed box holds it, or -1 (off the grid;
// NaN coordinates are in no box). The previous sample's block (hint, -1:
// none) is kept while the point lies strictly inside it: blocks do not
// overlap in volume (ops/simulation_kernel.py check_grid), so no other
// block's closed box holds such a point. A new block resets the face
// counts, which belong to the old block's faces.
template <typename T>
__device__ __forceinline__ int find_block(const BlockGridView<T>& g, const SksPoint<T>& p,
                                          int& hint, int (&faces)[3]) {
  if (hint >= 0) {
    const T* bb = g.bounds + 6 * hint;
    if (p.r > __ldg(bb) && p.r < __ldg(bb + 1) && p.th > __ldg(bb + 2) &&
        p.th < __ldg(bb + 3) && p.ph > __ldg(bb + 4) && p.ph < __ldg(bb + 5)) {
      return hint;
    }
  }
  int found = -1;
  if (!is_off_grid(g.cells, p)) {
#pragma unroll 1
    for (int b = 0; b < g.n_b; ++b) {
      const T* bb = g.bounds + 6 * b;
      if (p.r >= __ldg(bb) && p.r <= __ldg(bb + 1) && p.th >= __ldg(bb + 2) &&
          p.th <= __ldg(bb + 3) && p.ph >= __ldg(bb + 4) && p.ph <= __ldg(bb + 5)) {
        found = b;
        break;
      }
    }
  }
  if (found != hint) {
    faces[0] = faces[1] = faces[2] = -1;
    hint = found;
  }
  return found;
}

// The count of faces below x among a block's n + 1 faces xf: walked from
// `hint` (the count at the ray's previous sample in this block), or, with
// no hint (-1), a binary search; the result becomes the hint. As
// faces_below: the faces are non-decreasing, x NaN gives 0.
template <typename T>
__device__ __forceinline__ int block_faces_below(const T* xf, int n, T x, int& hint) {
  int q = hint;
  if (q < 0) {
    int lo = 0, hi = n + 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(xf + mid) < x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    q = lo;
  } else if (q <= n && __ldg(xf + q) < x) {
    do {
      ++q;
    } while (q <= n && __ldg(xf + q) < x);
  } else {
    while (q > 0 && !(__ldg(xf + q - 1) < x)) --q;
  }
  hint = q;
  return q;
}

// One axis in block b: the containing cell i, the trilinear anchor i_m
// and fraction f (locate, on the block's faces and centres).
template <typename T>
struct BlockAxis {
  const T* xf;  // the block's n + 1 faces
  const T* xv;  // its n centres
  int n, i, i_m;
  T f;
};

template <typename T>
__device__ __forceinline__ BlockAxis<T> locate_in_block(const GridAxis<T>& a, int b, T x,
                                                        int& hint) {
  BlockAxis<T> o;
  const int n = a.n;
  o.n = n;
  o.xf = a.xf + static_cast<long long>(b) * (n + 1);
  o.xv = a.xv + static_cast<long long>(b) * n;
  o.i = min(max(block_faces_below(o.xf, n, x, hint) - 1, 0), n - 1);
  const T xv_i = __ldg(o.xv + o.i);
  const bool use_i = (o.i == 0) || (o.i != n - 1 && x >= xv_i);
  o.i_m = use_i ? o.i : o.i - 1;
  const T x_lo = use_i ? xv_i : __ldg(o.xv + o.i - 1);
  const T x_hi = use_i ? __ldg(o.xv + o.i + 1) : xv_i;
  o.f = (x - x_lo) / (x_hi - x_lo);
  return o;
}

// The trilinear blend of 8 cells (cell(corner) their table indices, in the
// corner order of sample_cell), the positivity repair of rho and pgas
// against corner 0 and the float32 storage of samples: sample_cell's sum,
// with its kappa channel where NV = 9.
template <typename T, typename Cell, int NV>
__device__ __forceinline__ void blend_cells(const float4* __restrict__ table, T f_i, T f_j, T f_k,
                                            Cell cell, T (&v)[NV],
                                            const float* __restrict__ kappa = nullptr) {
  const T w[8] = {(T(1) - f_k) * (T(1) - f_j) * (T(1) - f_i),
                  (T(1) - f_k) * (T(1) - f_j) * f_i,
                  (T(1) - f_k) * f_j * (T(1) - f_i),
                  (T(1) - f_k) * f_j * f_i,
                  f_k * (T(1) - f_j) * (T(1) - f_i),
                  f_k * (T(1) - f_j) * f_i,
                  f_k * f_j * (T(1) - f_i),
                  f_k * f_j * f_i};
  float anchor_rho = 0.0f, anchor_pgas = 0.0f, anchor_kappa = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const long long c = cell(corner);
    const float4 a = __ldg(table + 2 * c);
    const float4 b = __ldg(table + 2 * c + 1);
    if (corner == 0) {
      anchor_rho = a.x;
      anchor_pgas = a.y;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const T term = w[corner] * T(prim_at(a, b, q));
      v[q] = corner == 0 ? term : v[q] + term;
    }
    if constexpr (NV > 8) {
      const float k = kappa != nullptr ? __ldg(kappa + c) : 0.0f;
      if (corner == 0) anchor_kappa = k;
      const T term = w[corner] * T(k);
      v[8] = corner == 0 ? term : v[8] + term;
    }
  }
  if (v[0] <= T(0)) v[0] = T(anchor_rho);
  if (v[1] <= T(0)) v[1] = T(anchor_pgas);
  if constexpr (NV > 8) {
    if (v[8] <= T(0)) v[8] = T(anchor_kappa);
  }
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = T(static_cast<float>(v[q]));
}

// The cell index along one axis of an interblock corner (grid/sampling.py
// interblock_corners axis_index): ck the corner's raw index in the home
// block (-1..n), e its crossing left after clamping (table field), upper
// ck > n / 2, par the home block's location parity, c the containing cell
// and x, xv_c the coordinate and that cell's centre; case_ 0 same level, 1
// coarser, 2 finer.
__device__ __forceinline__ int interblock_index(int e, int par, int ck, bool upper, int n, int c,
                                                bool past_centre, int case_) {
  // a crossed axis with no grid there was clamped onto the home block:
  // e == 0 takes the clamped index
  const int cs = min(max(ck, 0), n - 1);
  if (case_ == 0) return e == 0 ? cs : (e == -1 ? n - 1 : 0);
  if (case_ == 1) return e == 0 ? (par * n + cs) >> 1 : (e == -1 ? n - 1 : 0);
  int fine = e == 0 ? (upper ? (cs - n / 2) * 2 : cs * 2) : (e == -1 ? n - 2 : 0);
  // nudged toward the sample; a crossed axis that exists compares its raw
  // index
  const int ca = e == 0 ? cs : ck;
  return fine + ((ca < c || (ca == c && past_centre)) ? 1 : 0);
}

// Exact interblock interpolation in block b (grid/sampling.py
// interblock_corners): unclamped anchors, fractions through ghost centres
// past the block faces (past the upper face the reference's x?v(b, n),
// the next block's first centre in the flat centre array, or for the last
// block the mirror through its upper face), and each corner's cell through
// the neighbour table.
template <typename T, int NV>
__device__ __forceinline__ void sample_interblock(const BlockGridView<T>& g, const SksPoint<T>& p,
                                                  int b, T (&v)[NV], int (&hint)[3],
                                                  const float* __restrict__ kappa) {
  const T x[3] = {p.r, p.th, p.ph};
  int n[3], c[3], base[3];
  bool past[3];
  T f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const BlockAxis<T> o = locate_in_block(g.cells.ax[a], b, x[a], hint[a]);
    const int m = o.n;
    const T xv_c = __ldg(o.xv + o.i);
    past[a] = x[a] > xv_c;
    base[a] = x[a] >= xv_c ? o.i : o.i - 1;
    const T xv_last = __ldg(o.xv + m - 1);
    const T lo = base[a] == -1 ? T(2) * __ldg(o.xf) - __ldg(o.xv) : __ldg(o.xv + base[a]);
    T hi;
    if (base[a] + 1 == m) {
      const T nxt = b == g.n_b - 1 ? T(2) * __ldg(o.xf + m) - xv_last : __ldg(o.xv + m);
      hi = T(2) * nxt - xv_last;
    } else {
      hi = __ldg(o.xv + base[a] + 1);
    }
    f[a] = (x[a] - lo) / (hi - lo);
    n[a] = m;
    c[a] = o.i;
  }
  const long long n_cells = static_cast<long long>(g.n_b) * n[2] * n[1] * n[0];
  const int* par = g.parity + 3 * b;
  blend_cells(g.cells.table, f[0], f[1], f[2],
              [&](int corner) {
                const int d[3] = {corner & 1, (corner >> 1) & 1, corner >> 2};
                int ck[3], side[3];
                bool upper[3];
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                  ck[a] = base[a] + d[a];
                  side[a] = ck[a] == -1 ? -1 : (ck[a] == n[a] ? 1 : 0);
                  upper[a] = ck[a] > n[a] / 2;
                }
                const int dir = (side[2] + 1) * 9 + (side[1] + 1) * 3 + (side[0] + 1);
                const int half = (upper[2] ? 4 : 0) + (upper[1] ? 2 : 0) + (upper[0] ? 1 : 0);
                const int* e = g.amr + ((b * 27 + dir) * 8 + half) * AMR_TABLE_FIELDS;
                const int case_ = __ldg(e + 1);
                int idx[3];
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                  idx[a] = interblock_index(__ldg(e + 2 + a), __ldg(par + a), ck[a], upper[a],
                                            n[a], c[a], past[a], case_);
                }
                // a fine cell may lie one past its row: the flat index
                // reads on, clamped at the table's end
                const long long cell =
                    ((static_cast<long long>(__ldg(e)) * n[2] + idx[2]) * n[1] + idx[1]) * n[0] +
                    idx[0];
                return min(max(cell, 0LL), n_cells - 1);
              },
              v, kappa);
}

// The sample at a point in block b under SAMPLE_BLOCKS: the nearest cell
// (no repair; its float32 values as they are), or trilinear interpolation
// clamped to the block.
template <typename T, int NV>
__device__ __forceinline__ void sample_block(const BlockGridView<T>& g, const SksPoint<T>& p,
                                             int b, T (&v)[NV], int (&hint)[3],
                                             const float* __restrict__ kappa) {
  const BlockAxis<T> oi = locate_in_block(g.cells.ax[0], b, p.r, hint[0]);
  const BlockAxis<T> oj = locate_in_block(g.cells.ax[1], b, p.th, hint[1]);
  const BlockAxis<T> ok = locate_in_block(g.cells.ax[2], b, p.ph, hint[2]);
  const int n_i = oi.n, n_j = oj.n, n_k = ok.n;
  const long long first = static_cast<long long>(b) * n_k * n_j * n_i;
  if (g.nearest) {
    const long long cell = first + (static_cast<long long>(ok.i) * n_j + oj.i) * n_i + oi.i;
    const float4 a = __ldg(g.cells.table + 2 * cell);
    const float4 c = __ldg(g.cells.table + 2 * cell + 1);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = T(prim_at(a, c, q));
    if constexpr (NV > 8) v[8] = T(kappa != nullptr ? __ldg(kappa + cell) : 0.0f);
    return;
  }
  const int i_m = min(max(oi.i_m, 0), n_i - 2);
  const int j_m = min(max(oj.i_m, 0), n_j - 2);
  const int k_m = min(max(ok.i_m, 0), n_k - 2);
  const long long anchor = first + (static_cast<long long>(k_m) * n_j + j_m) * n_i + i_m;
  blend_cells(g.cells.table, oi.f, oj.f, ok.f,
              [&](int corner) {
                const int dk = corner >> 2, dj = (corner >> 1) & 1, di = corner & 1;
                return anchor + (static_cast<long long>(dk) * n_j + dj) * n_i + di;
              },
              v, kappa);
}

// The sample of a point on the grid of many blocks (grid/sampling.py
// sample_sks) in MODE; false off the grid (no block holds the point).
// hint: the face counts of the ray's previous sample, block: its block
// (-1: none), both updated. kappa: sample_cell's.
template <int MODE, typename T, int NV>
__device__ __forceinline__ bool sample_blocks(const BlockGridView<T>& g, const SksPoint<T>& p,
                                              T (&v)[NV], int (&hint)[3], int& block,
                                              const float* __restrict__ kappa = nullptr) {
  const int b = find_block(g, p, block, hint);
  if (b < 0) return false;
  if constexpr (MODE == SAMPLE_INTERBLOCK) {
    sample_interblock(g, p, b, v, hint, kappa);
  } else {
    sample_block(g, p, b, v, hint, kappa);
  }
  return true;
}

// ---------------------------------------------------------------------------
// FMKS (iharm3d's funky modified Kerr-Schild coordinates; grid/iharm3d.py):
// SAMPLE_FMKS, a coordinate map in front of the one-block search. The grid
// keeps its native (x^1, x^2, phi) faces and centres; a sample inside the
// SKS domain (the launch's bounds, not the faces) becomes (x^1, x^2) by a
// bilinear lookup in the inverse table (grid/sampling.py fmks_native, the
// JAX package's forms and clamps), and is then sampled as SAMPLE_SINGLE
// samples its point (sample_cell), or at the nearest cell where the launch
// says so. An FMKS file holds one block.
constexpr int SAMPLE_FMKS = 3;
// Values of the map in a grid launch's host array `axes`, after the three
// axes' GUIDE_AXIS_VALUES: r_in, dr, dtheta, the SKS domain's r, theta and
// phi low and high, and the table's n1m and n2m.
constexpr int FMKS_MAP_VALUES = 11;

// The native grid (guided, as SAMPLE_SINGLE's), the table (2, n2m, n1m):
// x^1 and x^2 at r = r_in + i dr, theta = j dtheta, and the SKS domain.
template <typename T>
struct FmksGridView {
  GridView<T> cells;
  const T* __restrict__ map;
  T r_in, dr, dtheta;
  T lo[3], hi[3];
  int n1m, n2m;
  bool nearest;
};

template <typename T>
struct SampleGridOf<T, SAMPLE_FMKS> {
  using type = FmksGridView<T>;
};

__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }

// The table cell below t along an axis of top + 2 entries: floor(t)
// clamped to [0, top] before the conversion (0 for NaN).
template <typename T>
__device__ __forceinline__ int fmks_cell(T t, int top) {
  const T c = m_floor(t);
  return c > T(0) ? (c < T(top) ? static_cast<int>(c) : top) : 0;
}

// The sample of a point under SAMPLE_FMKS; false off the SKS domain.
// hint: each native axis' face count at the ray's previous sample (-1:
// none), updated. kappa: sample_cell's.
template <typename T, int NV>
__device__ __forceinline__ bool sample_fmks(const FmksGridView<T>& g, const SksPoint<T>& p,
                                            T (&v)[NV], int (&hint)[3],
                                            const float* __restrict__ kappa = nullptr) {
  if (p.r < g.lo[0] || p.r > g.hi[0] || p.th < g.lo[1] || p.th > g.hi[1] || p.ph < g.lo[2] ||
      p.ph > g.hi[2]) {
    return false;
  }
  const T fi = (p.r - g.r_in) / g.dr;
  const T fj = p.th / g.dtheta;
  const int i0 = fmks_cell(fi, g.n1m - 2);
  const int j0 = fmks_cell(fj, g.n2m - 2);
  const T wi = jmin(jmax(fi - T(i0), T(0)), T(1));
  const T wj = jmin(jmax(fj - T(j0), T(0)), T(1));
  const T* x1 = g.map + static_cast<long long>(j0) * g.n1m + i0;
  const T* x2 = x1 + static_cast<long long>(g.n2m) * g.n1m;
  SksPoint<T> q = p;
  q.r = (T(1) - wi) * __ldg(x1) + wi * __ldg(x1 + 1);
  q.th = (T(1) - wj) * ((T(1) - wi) * __ldg(x2) + wi * __ldg(x2 + 1)) +
         wj * ((T(1) - wi) * __ldg(x2 + g.n1m) + wi * __ldg(x2 + g.n1m + 1));
  if (!g.nearest) {
    sample_cell(g.cells, q, v, hint, kappa);
    return true;
  }
  // the nearest cell: the containing cell of each axis, its float32
  // values as they are
  const T x[3] = {q.r, q.th, q.ph};
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = min(max(faces_below(g.cells.ax[a], x[a], hint[a]) - 1, 0), g.cells.ax[a].n - 1);
  }
  const long long cell =
      (static_cast<long long>(c[2]) * g.cells.ax[1].n + c[1]) * g.cells.ax[0].n + c[0];
  const float4 a = __ldg(g.cells.table + 2 * cell);
  const float4 b = __ldg(g.cells.table + 2 * cell + 1);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = T(prim_at(a, b, k));
  if constexpr (NV > 8) v[8] = T(kappa != nullptr ? __ldg(kappa + cell) : 0.0f);
  return true;
}

// ---------------------------------------------------------------------------
// CKS (AthenaK's Cartesian Kerr-Schild grids; grid/athenak.py):
// SAMPLE_CKS_BLOCKS and SAMPLE_CKS_INTERBLOCK sample as SAMPLE_BLOCKS and
// SAMPLE_INTERBLOCK do (BlockModeOf), at the sample's own (x, y, z), which
// are the grid's coordinates (grid/sampling.py sample_grid): no cks_to_sks
// and no phi wrap; the host's neighbour table has no periodic axis
// (grid/amr.py), and a point outside every block is off the grid. The
// sample keeps its Kerr-Schild radius for the geometric cuts and the
// metric. One AthenaK block takes SAMPLE_CKS_BLOCKS (as the nearest cell
// of one block takes SAMPLE_BLOCKS). The fluid state is formed in the
// CKS metric (fluid_state_cks), u and b in CKS already.
constexpr int SAMPLE_CKS_BLOCKS = 4;
constexpr int SAMPLE_CKS_INTERBLOCK = 5;

template <int MODE>
constexpr bool IsCks = MODE == SAMPLE_CKS_BLOCKS || MODE == SAMPLE_CKS_INTERBLOCK;

// Whether a launch's mode (SimGridArgs::mode) is one of a CKS grid's.
inline bool is_cks_mode(int mode) {
  return mode == SAMPLE_CKS_BLOCKS || mode == SAMPLE_CKS_INTERBLOCK;
}

// The mode of many blocks that a CKS mode samples as.
template <int MODE>
constexpr int BlockModeOf = MODE == SAMPLE_CKS_INTERBLOCK ? SAMPLE_INTERBLOCK : SAMPLE_BLOCKS;

// A sample point of a CKS grid: x, y, z, the radius parts of q (r2, r)
// and the grid's coordinates (x, y, z) in the places of (r, th, ph)
// (ph_raw unused).
template <typename T>
__device__ __forceinline__ SksPoint<T> cks_point(T x, T y, T z, const KsRadius<T>& q) {
  SksPoint<T> p;
  p.x = x;
  p.y = y;
  p.z = z;
  p.r2 = q.r2;
  p.r = q.r;
  p.th = y;
  p.ph_raw = z;
  p.ph = z;
  return p;
}

// The sample point of a kernel of MODE at (x, y, z) of radius q: in SKS
// (cks_to_sks), or on a CKS grid cks_point.
template <int MODE, typename T>
__device__ __forceinline__ SksPoint<T> sample_point(const SimConsts<T>& c, T x, T y, T z,
                                                    const KsRadius<T>& q) {
  if constexpr (IsCks<MODE>) {
    return cks_point(x, y, z, q);
  } else {
    return cks_to_sks(c, x, y, z, q);
  }
}

// The same at (x, y, z) alone (the polarized derive kernel's samples).
template <int MODE, typename T>
__device__ __forceinline__ SksPoint<T> sample_point(const SimConsts<T>& c, T x, T y, T z) {
  return sample_point<MODE>(c, x, y, z, sample_radius(c, x, y, z));
}

// The point in a CKS grid's coordinates, where the sampler of many blocks
// reads them: x in the place of r.
template <typename T>
__device__ __forceinline__ SksPoint<T> cks_grid_point(const SksPoint<T>& p) {
  SksPoint<T> g = p;
  g.r = p.x;
  return g;
}

// The sample of a point of a CKS grid in MODE; false off the grid (no
// block holds the point). hint and block as sample_blocks'.
template <int MODE, typename T, int NV>
__device__ __forceinline__ bool sample_cks(const BlockGridView<T>& g, const SksPoint<T>& p,
                                           T (&v)[NV], int (&hint)[3], int& block,
                                           const float* __restrict__ kappa = nullptr) {
  return sample_blocks<BlockModeOf<MODE>>(g, cks_grid_point(p), v, hint, block, kappa);
}

// The snapshot as the C interface receives it: the (n_b, n_k, n_j, n_i, 8)
// float32 table, the coordinates in the rays' type, the guides (int32) and
// the host array of their axes (make_grid_view); the sampling mode
// (SAMPLE_*), the nearest-cell flag, the blocks, their bounds in the rays'
// type, under SAMPLE_INTERBLOCK the neighbour table and parities (int32),
// and under SAMPLE_FMKS the map's table in the rays' type (its values
// follow the axes' in `axes`); the electron entropy's (n_b, n_k, n_j, n_i)
// float32 table of a code_kappa launch, which only the mixture's C
// interfaces take (null otherwise).
struct SimGridArgs {
  const float* table;
  const void* coords;
  const int* guides;
  const double* axes;
  int n_i, n_j, n_k;
  int mode;
  bool nearest;
  int n_b;
  const void* bounds;
  const int* amr;
  const int* parity;
  const void* map;
  const float* kappa;

  template <typename T>
  GridView<T> view() const {
    return make_grid_view<T>(table, coords, guides, axes, n_i, n_j, n_k, n_b);
  }

  template <typename T>
  BlockGridView<T> block_view() const {
    return {view<T>(), static_cast<const T*>(bounds), amr, parity, n_b, nearest};
  }

  template <typename T>
  FmksGridView<T> fmks_view() const {
    FmksGridView<T> g;
    g.cells = view<T>();
    g.map = static_cast<const T*>(map);
    const double* v = axes + 3 * GUIDE_AXIS_VALUES;
    g.r_in = T(v[0]);
    g.dr = T(v[1]);
    g.dtheta = T(v[2]);
    for (int a = 0; a < 3; ++a) {
      g.lo[a] = T(v[3 + 2 * a]);
      g.hi[a] = T(v[4 + 2 * a]);
    }
    g.n1m = static_cast<int>(v[9]);
    g.n2m = static_cast<int>(v[10]);
    g.nearest = nearest;
    return g;
  }

  // Whether the mode and the blocks agree: one block for SAMPLE_SINGLE,
  // the neighbour table for SAMPLE_INTERBLOCK and SAMPLE_CKS_INTERBLOCK,
  // one block and a table of at least 2 x 2 for SAMPLE_FMKS.
  bool valid() const {
    if (n_i < 2 || n_j < 2 || n_k < 2 || n_b < 1) return false;
    if (mode == SAMPLE_SINGLE) return n_b == 1 && !nearest;
    if (mode == SAMPLE_FMKS) {
      const double* v = axes + 3 * GUIDE_AXIS_VALUES;
      return n_b == 1 && map != nullptr && v[9] >= 2.0 && v[10] >= 2.0;
    }
    if (mode == SAMPLE_BLOCKS || mode == SAMPLE_CKS_BLOCKS) return bounds != nullptr;
    return (mode == SAMPLE_INTERBLOCK || mode == SAMPLE_CKS_INTERBLOCK) && bounds != nullptr &&
           amr != nullptr && parity != nullptr && !nearest;
  }
};

// The view of the snapshot a kernel of MODE takes.
template <typename T, int MODE>
SampleGrid<T, MODE> grid_view_of(const SimGridArgs& g) {
  if constexpr (MODE == SAMPLE_SINGLE) {
    return g.view<T>();
  } else if constexpr (MODE == SAMPLE_FMKS) {
    return g.fmks_view<T>();
  } else {
    return g.block_view<T>();
  }
}

// CGS fluid state and SKS four-vectors from sampled primitives
// (models/synchrotron.py fluid_state, ops/sks.py).
template <typename T>
struct FluidState {
  T rho_cgs, pgas_cgs, n_e_cgs, bb_cgs, sigma, beta_inv, kb_tt_e, theta_e, b_sq;
  T ut, ur, uth, uph, bt, br, bth, bph;
};

template <typename T, int NV>
__device__ __forceinline__ void fluid_state(const SimConsts<T>& c, const SksPoint<T>& p,
                                            const T (&v)[NV], FluidState<T>& s) {
  using Forms = TypeForms<T>;
  const T r = p.r, r2 = p.r2, spin = c.spin;
  const T rho = v[0], pgas = v[1], uu1 = v[2], uu2 = v[3], uu3 = v[4];
  const T bb1 = v[5], bb2 = v[6], bb3 = v[7];
  s.rho_cgs = rho * c.d_unit;
  s.pgas_cgs = pgas * c.e_unit;
  s.n_e_cgs = (s.rho_cgs / c.mu_mp) / c.ne_div;
  const T cth = p.z / r;
  const T cth2 = cth * cth;
  const T sth2 = T(1) - cth2;
  const T sigma_m = r2 + c.a2 * cth2;
  const T w_m = T(2) * r / sigma_m;
  const T g_tt = -(T(1) - w_m);
  const T g_tr = w_m;
  const T g_tph = -w_m * spin * sth2;
  const T g_rr = T(1) + w_m;
  const T g_rph = -(T(1) + w_m) * spin * sth2;
  const T g_thth = sigma_m;
  const T g_phph = (r2 + c.a2 + w_m * c.a2 * sth2) * sth2;
  const T gi_tt = -(T(1) + w_m);
  const T gi_tr = w_m;
  const T gi_rph = (T(1) / sigma_m) * spin;

  const T uu0 = m_sqrt(T(1) + g_rr * uu1 * uu1 + T(2) * g_rph * uu1 * uu3 +
                       g_thth * uu2 * uu2 + g_phph * uu3 * uu3);
  const T lapse = T(1) / m_sqrt(-gi_tt);
  const T shift1 = -gi_tr / gi_tt;
  const T shift3 = -gi_rph / gi_tt;
  const T ut = uu0 / lapse;
  const T ur = uu1 - shift1 * uu0 / lapse;
  const T uth = uu2;
  const T uph = uu3 - shift3 * uu0 / lapse;
  const T ucov_r = g_tr * ut + g_rr * ur + g_rph * uph;
  const T ucov_th = g_thth * uth;
  const T ucov_ph = g_tph * ut + g_rph * ur + g_phph * uph;
  const T bt = ucov_r * bb1 + ucov_th * bb2 + ucov_ph * bb3;
  const T br = (bb1 + bt * ur) / ut;
  const T bth = (bb2 + bt * uth) / ut;
  const T bph = (bb3 + bt * uph) / ut;
  const T bcov_t = g_tt * bt + g_tr * br + g_tph * bph;
  const T bcov_r = g_tr * bt + g_rr * br + g_rph * bph;
  const T bcov_th = g_thth * bth;
  const T bcov_ph = g_tph * bt + g_rph * br + g_phph * bph;
  const T b_sq = bcov_t * bt + bcov_r * br + bcov_th * bth + bcov_ph * bph;

  if (Forms::F64) {
    s.bb_cgs = (b_sq > T(0) ? m_sqrt(b_sq) : T(0)) * c.b_unit;
  } else {
    s.bb_cgs = m_sqrt(jmax(b_sq, T(1e-30))) * c.b_unit;
  }
  s.sigma = b_sq / jmax(rho, Forms::div_floor());
  s.beta_inv = b_sq / jmax(T(2) * pgas, Forms::div_floor());
  const T u_b = T(1) / (T(1) + s.beta_inv * s.beta_inv);
  const T tti_tte = c.rat_high * u_b + c.rat_low * (T(1) - u_b);
  const T kb_tt_tot = c.kb_tot * (pgas / jmax(rho, Forms::div_floor()));
  T kb_tt_e;
  if (c.use_p) {
    kb_tt_e = (T(1) / (tti_tte + c.ne_ni)) * c.one_plus_ne_ni * kb_tt_tot;
  } else {
    kb_tt_e = c.one_plus_ne_ni * kb_tt_tot / c.gamma_m1;
    kb_tt_e = kb_tt_e / (tti_tte / c.gamma_i_m1 + c.ne_ni_over_gamma_e_m1);
  }
  s.kb_tt_e = kb_tt_e;
  s.theta_e = kb_tt_e / c.me_c2;
  s.b_sq = b_sq;
  s.ut = ut;
  s.ur = ur;
  s.uth = uth;
  s.uph = uph;
  s.bt = bt;
  s.br = br;
  s.bth = bth;
  s.bph = bph;
}

// The fluid state at a point p of a CKS grid (cks_point) from sampled CKS
// primitives (models/synchrotron.py fluid_state with coords "cks",
// cks_frame): the normal-frame velocity and the cell-frame field in the
// Kerr-Schild metric g = eta + f l l (l_0 = 1; at the point's radius, as
// ops/geometry.py ks_scalars), u and b in CKS (ucon, bcon), then
// fluid_state's scalars from b^2. Each sum runs over its index in order,
// cks_frame's forms.
template <typename T, int NV>
__device__ __forceinline__ void fluid_state_cks(const SimConsts<T>& c, const SksPoint<T>& p,
                                                const T (&v)[NV], FluidState<T>& s, T (&ucon)[4],
                                                T (&bcon)[4]) {
  using Forms = TypeForms<T>;
  const T r = p.r, r2 = p.r2, x = p.x, y = p.y, z = p.z;
  const T rho = v[0], pgas = v[1];
  const T uu[3] = {v[2], v[3], v[4]};
  const T bb[3] = {v[5], v[6], v[7]};
  s.rho_cgs = rho * c.d_unit;
  s.pgas_cgs = pgas * c.e_unit;
  s.n_e_cgs = (s.rho_cgs / c.mu_mp) / c.ne_div;

  const T f = T(2) * r2 * r / (r2 * r2 + c.a2 * z * z);
  const T denom = r2 + c.a2;
  const T l[3] = {(r * x + c.spin * y) / denom, (r * y - c.spin * x) / denom, z / r};
  const T fl[3] = {f * l[0], f * l[1], f * l[2]};
  // g[m][n], m, n = 0..3
  T g[4][4];
  g[0][0] = f - T(1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[0][i + 1] = fl[i];
    g[i + 1][0] = fl[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) g[i + 1][j + 1] = i == j ? T(1) + fl[i] * l[j] : fl[i] * l[j];
  }
  T rows[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rows[i] = g[i + 1][1] * uu[0] + g[i + 1][2] * uu[1] + g[i + 1][3] * uu[2];
  }
  const T uu0 = m_sqrt(T(1) + (uu[0] * rows[0] + uu[1] * rows[1] + uu[2] * rows[2]));
  const T lapse = T(1) / m_sqrt(T(1) + f);
  const T ut = uu0 / lapse;
  ucon[0] = ut;
#pragma unroll
  for (int i = 0; i < 3; ++i) ucon[i + 1] = uu[i] - fl[i] / (T(1) + f) * ut;
  T ucov[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    ucov[m] = g[m][0] * ucon[0] + g[m][1] * ucon[1] + g[m][2] * ucon[2] + g[m][3] * ucon[3];
  }
  const T bt = ucov[1] * bb[0] + ucov[2] * bb[1] + ucov[3] * bb[2];
  bcon[0] = bt;
#pragma unroll
  for (int i = 0; i < 3; ++i) bcon[i + 1] = (bb[i] + bt * ucon[i + 1]) / ut;
  T bcov[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    bcov[m] = g[m][0] * bcon[0] + g[m][1] * bcon[1] + g[m][2] * bcon[2] + g[m][3] * bcon[3];
  }
  const T b_sq = bcov[0] * bcon[0] + bcov[1] * bcon[1] + bcov[2] * bcon[2] + bcov[3] * bcon[3];

  // fluid_state's scalars
  if (Forms::F64) {
    s.bb_cgs = (b_sq > T(0) ? m_sqrt(b_sq) : T(0)) * c.b_unit;
  } else {
    s.bb_cgs = m_sqrt(jmax(b_sq, T(1e-30))) * c.b_unit;
  }
  s.sigma = b_sq / jmax(rho, Forms::div_floor());
  s.beta_inv = b_sq / jmax(T(2) * pgas, Forms::div_floor());
  const T u_b = T(1) / (T(1) + s.beta_inv * s.beta_inv);
  const T tti_tte = c.rat_high * u_b + c.rat_low * (T(1) - u_b);
  const T kb_tt_tot = c.kb_tot * (pgas / jmax(rho, Forms::div_floor()));
  T kb_tt_e;
  if (c.use_p) {
    kb_tt_e = (T(1) / (tti_tte + c.ne_ni)) * c.one_plus_ne_ni * kb_tt_tot;
  } else {
    kb_tt_e = c.one_plus_ne_ni * kb_tt_tot / c.gamma_m1;
    kb_tt_e = kb_tt_e / (tti_tte / c.gamma_i_m1 + c.ne_ni_over_gamma_e_m1);
  }
  s.kb_tt_e = kb_tt_e;
  s.theta_e = kb_tt_e / c.me_c2;
  s.b_sq = b_sq;
}

// Value cuts (models/synchrotron.py value_cuts); a cut that is off is
// +-inf in SimConsts, which no value fails (NaN fails none either).
template <typename T>
__device__ __forceinline__ bool value_keep(const SimConsts<T>& c, const FluidState<T>& s) {
  const T cut_values[7] = {s.rho_cgs, s.n_e_cgs, s.pgas_cgs, s.theta_e,
                           s.bb_cgs,  s.sigma,   s.beta_inv};
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    if (cut_values[q] < c.value_lo[q]) return false;
    if (cut_values[q] > c.value_hi[q]) return false;
  }
  return true;
}

// u^mu and b^mu in CKS (ops/sks.py sks_to_cks_vector).
template <typename T>
__device__ __forceinline__ void fluid_cks(const SksPoint<T>& p, T spin, const FluidState<T>& s,
                                          T (&ucon)[4], T (&bcon)[4]) {
  const T r = p.r;
  const T cth = p.z / r;
  const T sth = m_sqrt(jmax(T(1) - cth * cth, T(0)));
  const T sph = m_sin(p.ph_raw), cph = m_cos(p.ph_raw);
  const T e_r[3] = {sth * cph, sth * sph, cth};
  const T e_th[3] = {cth * (r * cph - spin * sph), cth * (r * sph + spin * cph), -r * sth};
  const T e_ph[3] = {sth * (-r * sph - spin * cph), sth * (r * cph - spin * sph), T(0)};
  ucon[0] = s.ut;
  ucon[1] = e_r[0] * s.ur + e_th[0] * s.uth + e_ph[0] * s.uph;
  ucon[2] = e_r[1] * s.ur + e_th[1] * s.uth + e_ph[1] * s.uph;
  ucon[3] = e_r[2] * s.ur - r * sth * s.uth;
  bcon[0] = s.bt;
  bcon[1] = e_r[0] * s.br + e_th[0] * s.bth + e_ph[0] * s.bph;
  bcon[2] = e_r[1] * s.br + e_th[1] * s.bth + e_ph[1] * s.bph;
  bcon[3] = e_r[2] * s.br - r * sth * s.bth;
}

// Pitch angle from invariants (models/synchrotron.py pitch_angle):
// cos^2 and sin^2 of the fluid-frame angle between k and b, u.k and b.k.
template <typename T>
struct Pitch {
  T u_dot_k, b_dot_k, cos2, sin2;
};

template <typename T>
__device__ __forceinline__ Pitch<T> pitch_angle(T p0, T k1, T k2, T k3, const T (&ucon)[4],
                                                const T (&bcon)[4], T b_sq) {
  using Forms = TypeForms<T>;
  Pitch<T> q;
  q.u_dot_k = ucon[0] * p0 + ucon[1] * k1 + ucon[2] * k2 + ucon[3] * k3;
  q.b_dot_k = bcon[0] * p0 + bcon[1] * k1 + bcon[2] * k2 + bcon[3] * k3;
  const T denom = q.u_dot_k * q.u_dot_k * jmax(b_sq, Forms::pitch_floor());
  q.cos2 = jmin(q.b_dot_k * q.b_dot_k / denom, T(1));
  q.sin2 = T(1) - q.cos2;
  return q;
}

// sqrt(v) above the type's cut, else 0 (pitch_angle's safe_sqrt).
template <typename T>
__device__ __forceinline__ T safe_sqrt(T v) {
  return v > TypeForms<T>::sqrt_cut() ? m_sqrt(v) : T(0);
}

// Thermal j_I and alpha_I at one fluid-frame frequency
// (models/synchrotron.py thermal_coefficients :785-878), with the pieces
// the polarized coefficients reuse. alpha is already zeroed where the
// reference's overflow trap holds (trap).
template <typename T>
struct ThermalI {
  T xx, xx_1_3, xx_1_2, xx_1_6, coefficient, var_a, kirch, j, alpha;
  bool trap;
};

template <typename T>
__device__ __forceinline__ ThermalI<T> thermal_i(const SimConsts<T>& c, T nu_cgs, T n_e_cgs,
                                                 T nu_c, T nu_s, T sin_b, T kb_tt_e) {
  using Forms = TypeForms<T>;
  ThermalI<T> t;
  T xx = nu_cgs / nu_s;
  if (!Forms::F64) xx = jmin(xx, T(1e20));
  t.xx = xx;
  t.xx_1_3 = m_copysign(m_pow(m_abs(xx), T(1.0 / 3.0)), xx);
  t.xx_1_2 = m_sqrt(xx);
  t.xx_1_6 = m_sqrt(t.xx_1_3);
  const T ratio = (T(1) / nu_cgs) * c.nu0;
  t.coefficient = c.thermal_frac * n_e_cgs * nu_c * (ratio * ratio) * m_exp(-t.xx_1_3);
  t.var_a = c.var_a * sin_b;
  const T var_c = t.xx_1_2 + c.var_b * t.xx_1_6;
  t.j = t.coefficient * t.var_a * var_c * var_c;
  T hnu_kt;
  if (Forms::F64) {
    hnu_kt = c.h_planck * nu_cgs / kb_tt_e;
  } else {
    hnu_kt = jmin(c.h_planck * nu_cgs / jmax(kb_tt_e, T(1e-18)), T(87));
  }
  t.kirch = m_expm1(hnu_kt) * c.kirchhoff;
  t.alpha = t.j * t.kirch;
  t.trap = m_isinf((T(1) / (t.alpha * t.alpha)));
  if (t.trap) t.alpha = T(0);
  return t;
}

// ---------------------------------------------------------------------------
// The power-law and kappa populations (models/synchrotron.py
// powerlaw_coefficients :556-641, _bridge, kappa_coefficients :665-748,
// all_coefficients :751-782), beside the thermal one. A kernel sums them
// only in its POP_MIXTURE instantiations, which live in units of their
// own; the POP_THERMAL ones are the kernels as they were.
constexpr int POP_THERMAL = 0;
constexpr int POP_MIXTURE = 1;

// The values a sample takes of the table: the 8 primitives, and under
// POP_MIXTURE the electron entropy (sample_cell).
template <int POP>
constexpr int SampleValues = POP == POP_MIXTURE ? 9 : 8;

// The MixtureParam constants of a launch, each rounded once to T: from
// the float64 vector in device memory (the polarized derive kernel), or
// from launch constants the host already rounded to T (the simulation
// kernels, which then read them from the constant bank).
template <typename T>
struct MixConsts {
  T v[M_COUNT];

  __device__ explicit MixConsts(const double* p) {
#pragma unroll
    for (int m = 0; m < M_COUNT; ++m) v[m] = T(p[m]);
  }
  __device__ MixConsts(const T* p, RoundedConsts) {
#pragma unroll
    for (int m = 0; m < M_COUNT; ++m) v[m] = p[m];
  }
  __device__ __forceinline__ T operator[](int m) const { return v[m]; }
  __device__ __forceinline__ bool on(int m) const { return v[m] != T(0); }
};

// torch.pow(x, e) of a scalar exponent as PyTorch evaluates it: its
// special exponents by their own forms, the rest by pow.
template <typename T>
__device__ __forceinline__ T pow_s(T x, T e) {
  if (e == T(0.5)) return m_sqrt(x);
  if (e == T(1)) return x;
  if (e == T(2)) return x * x;
  if (e == T(3)) return x * x * x;
  if (e == T(-0.5)) return T(1) / m_sqrt(x);
  if (e == T(-1)) return T(1) / x;
  if (e == T(-2)) return T(1) / (x * x);
  return m_pow(x, e);
}

// models/synchrotron.py cbrt: the real cube root, odd in x.
template <typename T>
__device__ __forceinline__ T cbrt_s(T x) {
  return m_copysign(m_pow(m_abs(x), T(1.0 / 3.0)), x);
}

// The code_kappa electron temperature in place of fluid_state's ti_te_beta
// one where the launch says so (M_CODE_KAPPA), from the sampled density
// and electron entropy (models/synchrotron.py code_kappa_temperature, its
// forms: rho_e = rho m_e / (mu_e m_p), theta_e = 0.2 (sqrt(1 + 25
// cbrt(rho_e kappa)^2) - 1), kb_tt_e = theta_e m_e c^2). The cube root is
// cbrt_s, |x|^(1/3) as the plain version takes it, not the library's
// cbrt: the two then round alike.
template <typename T>
__device__ __forceinline__ void code_kappa_state(const MixConsts<T>& m, T rho, T kappa,
                                                 FluidState<T>& s) {
  if (!m.on(M_CODE_KAPPA)) return;
  const T rho_e = rho * m[M_CK_ME] / m[M_CK_MU_E_MP];
  const T c = cbrt_s(rho_e * kappa);
  s.theta_e = T(0.2) * (m_sqrt(T(1) + T(25) * (c * c)) - T(1));
  s.kb_tt_e = s.theta_e * m[M_CK_ME] * m[M_CK_C2];
}

// sign(cos theta_B) as the coefficients take it: +1 where cos >= 0.
template <typename T>
__device__ __forceinline__ T cos_sign(T cos_b) {
  return cos_b >= T(0) ? T(1) : T(-1);
}

// The bridge (low^-x + high^-x)^(-1/x) as m (1 + (m / M)^x)^(-1/x)
// (models/synchrotron.py _bridge); nx = -1 / x, folded on the host. NaN
// propagates through the min and max, as torch.minimum's does.
template <typename T>
__device__ __forceinline__ T bridge(T low, T high, T x, T nx) {
  const T mn = jmin(low, high);
  const T mx = jmax(low, high);
  const bool ok = mx > TypeForms<T>::bridge_floor();
  const T r = (ok ? mn : T(0)) / (ok ? mx : T(1));
  const bool pos = r > T(1e-30);
  const T rx = pos ? pow_s(r, x) : T(0);
  return mn * pow_s(T(1) + rx, nx);
}

// What the power-law and kappa coefficients share at one frequency:
// (nu0 / nu_cgs)^2 in torch's form of a scalar numerator.
template <typename T>
__device__ __forceinline__ T nu0_ratio_sq(const SimConsts<T>& c, T nu_cgs) {
  const T ratio = (T(1) / nu_cgs) * c.nu0;
  return ratio * ratio;
}

// The kappa population's xx = nu / nu_kappa and the two bracket terms of
// its j_I and alpha_I (models/synchrotron.py kappa_coefficients).
template <typename T>
struct KappaTerms {
  T xx, c_low, c_high, a_low, a_high;
};

template <typename T>
__device__ __forceinline__ KappaTerms<T> kappa_terms(const MixConsts<T>& m, T r2, T nu_cgs,
                                                     T n_e, T nu_c, T sin_b) {
  KappaTerms<T> k;
  const T nu_kappa = nu_c * m[M_KP_W] * m[M_KP_W] * m[M_KP_KAPPA] * m[M_KP_KAPPA] * sin_b;
  k.xx = nu_cgs / jmax(nu_kappa, TypeForms<T>::pop_floor());
  const T var_a = m[M_KP_FRAC] * n_e * nu_c * r2;
  const T var_b = cbrt_s(k.xx) * sin_b;
  const T var_c = pow_s(k.xx, m[M_KP_J_EXP]) * sin_b;
  k.c_low = var_a * m[M_KP_JJ_LOW] * var_b;
  k.c_high = var_a * m[M_KP_JJ_HIGH] * var_c;
  const T var_a2 = m[M_KP_FRAC] * n_e * m[M_KA];
  k.a_low = var_a2 * m[M_KP_AA_LOW] * pow_s(k.xx, T(-2.0 / 3.0));
  k.a_high = var_a2 * m[M_KP_AA_HIGH] * pow_s(k.xx, m[M_KP_A_EXP]);
  return k;
}

// j_I and alpha_I of the mixture at one fluid-frame frequency: the
// thermal ones (ti, from thermal_i) where the thermal fraction is not 0,
// plus the power-law and the kappa ones where theirs are not, summed in
// that order (models/synchrotron.py all_coefficients).
template <typename T>
__device__ __forceinline__ void mixture_i(const MixConsts<T>& m, const SimConsts<T>& c,
                                          const ThermalI<T>& ti, T nu_cgs, T n_e, T nu_c,
                                          T sin_b, T& j, T& alpha) {
  bool have = m.on(M_THERMAL_ON);
  j = ti.j;
  alpha = ti.alpha;
  const T r2 = nu0_ratio_sq(c, nu_cgs);
  if (m.on(M_POWER_ON)) {
    const T ncs = jmax(nu_c * sin_b, TypeForms<T>::pop_floor());
    const T ratio = nu_cgs / ncs;
    const T var_a = pow_s(ratio, m[M_PL_J_EXP]);
    const T pj = m[M_PL_FRAC] * n_e * nu_c * r2 * m[M_PL_JJ] * sin_b * var_a;
    const T pa = m[M_PL_FRAC] * n_e * m[M_KA] * m[M_PL_AA] * pow_s(ratio, m[M_PL_A_EXP]);
    j = have ? j + pj : pj;
    alpha = have ? alpha + pa : pa;
    have = true;
  }
  if (m.on(M_KAPPA_ON)) {
    const KappaTerms<T> k = kappa_terms(m, r2, nu_cgs, n_e, nu_c, sin_b);
    const T kj = bridge(k.c_low, k.c_high, m[M_KP_X_JI], m[M_KP_NX_JI]);
    const T ka = bridge(k.a_low, k.a_high * m[M_KP_AA_HIGH_I], m[M_KP_X_AI], m[M_KP_NX_AI]);
    j = have ? j + kj : kj;
    alpha = have ? alpha + ka : ka;
  }
}

}  // namespace bl
