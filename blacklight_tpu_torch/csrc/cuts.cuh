// Geometric sample cuts shared by the fused kernels: camera radius,
// near/far half-space, spheres, midplane slab and an arbitrary plane
// (blacklight_tpu/models/cuts.py geometric_keep :49-81; the reference's
// simulation_sampling.cpp:238-295 and formula_coefficients.cpp:73-116).
#pragma once

#include "kerr.cuh"

namespace bl {

// Index order of the cut block inside a kernel's float64 parameter vector,
// relative to its first entry (models/cuts.py cut_param_values fills it):
// an _ON flag or a sign (-1, 0, +1) decided on the host from the float64
// value, then the value (a magnitude for the signs).
enum CutParam : int {
  C_NEAR,
  C_FAR,
  C_IN_ON,
  C_IN,
  C_OUT_ON,
  C_OUT,
  C_MID_THETA_SIGN,
  C_MID_THETA,
  C_MID_Z_SIGN,
  C_MID_Z,
  C_PLANE,
  C_PLANE_OX,
  C_PLANE_OY,
  C_PLANE_OZ,
  C_PLANE_NX,
  C_PLANE_NY,
  C_PLANE_NZ,
  C_COUNT
};

constexpr double HALF_PI = 1.5707963267948966;

template <typename T>
struct CutConsts {
  bool near, far, in_on, out_on, plane;
  int mid_theta_sign, mid_z_sign;
  T in, out, mid_theta, mid_z;
  T plane_o[3], plane_n[3];

  // c points at the block's first entry: float64 values, or values the
  // host already rounded to T
  template <typename S>
  __device__ explicit CutConsts(const S* c) {
    near = T(c[C_NEAR]) != T(0);
    far = T(c[C_FAR]) != T(0);
    in_on = T(c[C_IN_ON]) != T(0);
    in = T(c[C_IN]);
    out_on = T(c[C_OUT_ON]) != T(0);
    out = T(c[C_OUT]);
    mid_theta_sign = static_cast<int>(c[C_MID_THETA_SIGN]);
    mid_theta = T(c[C_MID_THETA]);
    mid_z_sign = static_cast<int>(c[C_MID_Z_SIGN]);
    mid_z = T(c[C_MID_Z]);
    plane = T(c[C_PLANE]) != T(0);
    plane_o[0] = T(c[C_PLANE_OX]);
    plane_o[1] = T(c[C_PLANE_OY]);
    plane_o[2] = T(c[C_PLANE_OZ]);
    plane_n[0] = T(c[C_PLANE_NX]);
    plane_n[1] = T(c[C_PLANE_NY]);
    plane_n[2] = T(c[C_PLANE_NZ]);
  }
};

// True where the sample at CKS (x1, x2, x3), of Kerr-Schild radius r,
// survives every cut; cam1..cam3 is the camera position.
template <typename T>
__device__ __forceinline__ bool geometric_keep(const CutConsts<T>& c, T x1, T x2,
                                               T x3, T r, T camera_r, T cam1,
                                               T cam2, T cam3) {
  bool keep = r <= camera_r;
  if (c.near || c.far) {
    const T dot = x1 * cam1 + x2 * cam2 + x3 * cam3;
    if (c.near) keep = keep && !(dot > T(0));
    if (c.far) keep = keep && !(dot < T(0));
  }
  if (c.in_on) keep = keep && !(r < c.in);
  if (c.out_on) keep = keep && !(r > c.out);
  if (c.mid_theta_sign != 0) {
    const T off = m_abs(m_acos(x3 / r) - T(HALF_PI));
    keep = keep && (c.mid_theta_sign > 0 ? !(off > c.mid_theta) : !(off < c.mid_theta));
  }
  if (c.mid_z_sign != 0) {
    const T az = m_abs(x3);
    keep = keep && (c.mid_z_sign > 0 ? !(az > c.mid_z) : !(az < c.mid_z));
  }
  if (c.plane) {
    keep = keep && !((x1 - c.plane_o[0]) * c.plane_n[0] + (x2 - c.plane_o[1]) * c.plane_n[1] +
                         (x3 - c.plane_o[2]) * c.plane_n[2] <
                     T(0));
  }
  return keep;
}

}  // namespace bl
