"""Fused formula-model kernel: geodesics + coefficients + unpolarized
transfer, one frequency.

Port of ``blacklight_tpu/ops/pallas_formula.py`` (``_make_kernel``
:192-596, ``render_formula`` :599-697) without forward tangents and for a
single frequency.

``render_formula`` dispatches on the device of the tensors it is given: on
a CUDA device it launches the hand-written kernel
(``csrc/formula_kernel.cuh``) or raises; on the CPU it runs
``render_formula_reference``, the same function in plain torch ops. There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from blacklight_tpu.constants import Physics
from blacklight_tpu_torch.models.formula import (
    FormulaParams,
    cpp_pow_exponent,
    formula_geom_c,
    formula_jalpha_c,
)
from blacklight_tpu_torch.ops import _build
from blacklight_tpu_torch.ops import geodesic as geo
from blacklight_tpu_torch.ops.geometry import (
    geodesic_rhs_c,
    radius_c,
    renormalize_factor_c,
)

DELTA_TAU_MAX = 100.0
INTEGRATORS = ("dp", "rk4", "rk2")
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

# Kernel launches so far; render_formula adds one per launch of the CUDA
# kernel and nowhere else.
LAUNCHES = 0

# Index order of the kernel's float64 parameter vector: the enum in
# csrc/formula_params.cuh with its "P_" prefix dropped.
PARAM_NAMES = (
    "SPIN", "A2", "TWO_SPIN", "TWO_A2", "THREE_A2", "TWO_MASS",
    "FLAT", "RAY_STEP", "CAMERA_R", "R_TERMINATE", "R_HORIZON", "TOL_ABS",
    "TOL_REL", "MAX_STEPS", "MAX_RETRIES", "FALLBACK_NAN",
    "F_BH_A", "F_A2", "F_TWO_A", "F_TWO_M", "F_NEG_TWO_M_A", "F_CAMERA_R",
    "F_L0", "F_ONE_PLUS_Q", "F_INV_R0_SQ", "F_H_SQ", "F_INV_NUP",
    "F_A_PARAM",
    "F_CN0", "EJ", "EJ_IS_INT", "EJ_SIGN", "EA", "EA_IS_INT", "EA_SIGN",
    "CUT_NEAR", "CUT_FAR", "CUT_IN_ON", "CUT_IN", "CUT_OUT_ON", "CUT_OUT",
    "CUT_MID_THETA_SIGN", "CUT_MID_THETA", "CUT_MID_Z_SIGN", "CUT_MID_Z",
    "CUT_PLANE", "PLANE_OX", "PLANE_OY", "PLANE_OZ", "PLANE_NX", "PLANE_NY",
    "PLANE_NZ", "CAM_X0", "CAM_X1", "CAM_X2", "CAM_X3", "NU",
    "X_UNIT_OVER_NU", "I_SCALE",
)


def _sign(v: float) -> float:
    return 1.0 if v > 0.0 else (-1.0 if v < 0.0 else 0.0)


def kernel_params(params: geo.GeodesicParams, fp: FormulaParams, nu: float,
                  mass_msun: float, camera_x, log_j_scale: float,
                  fallback_nan: bool) -> list:
    """The kernel's parameter vector in PARAM_NAMES order, every derived
    constant computed here in float64 (the kernel rounds each once to its
    working type, as JAX rounds a Python scalar)."""
    spin, mass = params.bh_a, params.bh_m
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    ej = -fp.alpha - 2.0
    ea = -fp.beta - fp.alpha
    ej_int, ej_sign = cpp_pow_exponent(ej)
    ea_int, ea_sign = cpp_pow_exponent(ea)
    cam = [float(v) for v in camera_x]
    values = {
        "SPIN": spin, "A2": spin * spin, "TWO_SPIN": 2.0 * spin,
        "TWO_A2": 2.0 * (spin * spin), "THREE_A2": 3.0 * (spin * spin),
        "TWO_MASS": 2.0 * mass, "FLAT": params.ray_flat,
        "RAY_STEP": params.ray_step, "CAMERA_R": params.camera_r,
        "R_TERMINATE": params.r_terminate, "R_HORIZON": params.r_horizon,
        "TOL_ABS": params.ray_tol_abs, "TOL_REL": params.ray_tol_rel,
        "MAX_STEPS": params.ray_max_steps,
        "MAX_RETRIES": params.ray_max_retries,
        "FALLBACK_NAN": fallback_nan,
        "F_BH_A": fp.bh_a, "F_A2": fp.bh_a * fp.bh_a,
        "F_TWO_A": 2.0 * fp.bh_a, "F_TWO_M": 2.0 * fp.bh_m,
        "F_NEG_TWO_M_A": -2.0 * fp.bh_m * fp.bh_a,
        "F_CAMERA_R": fp.camera_r, "F_L0": fp.l0,
        "F_ONE_PLUS_Q": 1.0 + fp.q, "F_INV_R0_SQ": 1.0 / (fp.r0 * fp.r0),
        "F_H_SQ": fp.h * fp.h, "F_INV_NUP": 1.0 / fp.nup,
        "F_A_PARAM": fp.a_param,
        "F_CN0": fp.cn0,
        "EJ": ej, "EJ_IS_INT": ej_int, "EJ_SIGN": ej_sign,
        "EA": ea, "EA_IS_INT": ea_int, "EA_SIGN": ea_sign,
        "CUT_NEAR": fp.cut_omit_near, "CUT_FAR": fp.cut_omit_far,
        "CUT_IN_ON": fp.cut_omit_in >= 0.0, "CUT_IN": fp.cut_omit_in,
        "CUT_OUT_ON": fp.cut_omit_out >= 0.0, "CUT_OUT": fp.cut_omit_out,
        "CUT_MID_THETA_SIGN": _sign(fp.cut_midplane_theta),
        "CUT_MID_THETA": abs(fp.cut_midplane_theta),
        "CUT_MID_Z_SIGN": _sign(fp.cut_midplane_z),
        "CUT_MID_Z": abs(fp.cut_midplane_z),
        "CUT_PLANE": fp.cut_plane,
        "PLANE_OX": fp.cut_plane_origin[0], "PLANE_OY": fp.cut_plane_origin[1],
        "PLANE_OZ": fp.cut_plane_origin[2], "PLANE_NX": fp.cut_plane_normal[0],
        "PLANE_NY": fp.cut_plane_normal[1], "PLANE_NZ": fp.cut_plane_normal[2],
        "CAM_X0": cam[0], "CAM_X1": cam[1], "CAM_X2": cam[2],
        "CAM_X3": cam[3], "NU": nu, "X_UNIT_OVER_NU": x_unit / nu,
        "I_SCALE": math.exp(log_j_scale + 3.0 * math.log(nu)),
    }
    if set(values) != set(PARAM_NAMES):
        raise AssertionError(sorted(set(values) ^ set(PARAM_NAMES)))
    return [float(values[name]) for name in PARAM_NAMES]


def _check_rays(positions, directions, momentum_factors):
    """Validate the ray bundle the kernel reads: (B, 4), (B, 4), (B,),
    one float dtype, one device, contiguous."""
    b = positions.shape[0] if positions.dim() == 2 else -1
    if (positions.shape != (b, 4) or directions.shape != (b, 4)
            or momentum_factors.shape != (b,)):
        raise ValueError(
            "expected positions (B, 4), directions (B, 4) and "
            f"momentum_factors (B,); got {tuple(positions.shape)}, "
            f"{tuple(directions.shape)}, {tuple(momentum_factors.shape)}")
    dtype, device = positions.dtype, positions.device
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"rays must be float32 or float64, not {dtype}")
    for t in (directions, momentum_factors):
        if t.dtype != dtype or t.device != device:
            raise TypeError("rays must share one dtype and one device")
    for t in (positions, directions, momentum_factors):
        if not t.is_contiguous():
            raise ValueError("rays must be contiguous")


def render_formula(positions, directions, momentum_factors, frequency: float,
                   params: geo.GeodesicParams, fp: FormulaParams,
                   mass_msun: float, camera_x, log_j_scale: float,
                   fallback_nan: bool = True, integrator: str = "dp"):
    """Fused render of a ray bundle at one frequency.

    Args:
      positions, directions: (B, 4) camera rays (covariant momenta), float32
        or float64, contiguous; momentum_factors: (B,).
      frequency: image frequency in Hz. params / fp: geodesic and formula
        parameters. camera_x: the camera position (4 values).
      log_j_scale: models.formula.formula_log_j_scale(fp).
      integrator: "dp", "rk4" or "rk2".

    Returns (I_nu (B, 1), flags (B,) bool, n_samples (B,) int32), on the
    rays' device and in their dtype. A CUDA device runs the CUDA kernel;
    the CPU runs ``render_formula_reference``.
    """
    _check_rays(positions, directions, momentum_factors)
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator must be one of {INTEGRATORS}")
    device = positions.device
    if device.type == "cuda":
        return _render_cuda(positions, directions, momentum_factors,
                            float(frequency), params, fp, mass_msun, camera_x,
                            log_j_scale, fallback_nan, integrator)
    if device.type == "cpu":
        return render_formula_reference(
            positions, directions, momentum_factors, frequency, params, fp,
            mass_msun, camera_x, log_j_scale, fallback_nan=fallback_nan,
            integrator=integrator)
    raise ValueError(f"no formula kernel for device {device}")


def _render_cuda(positions, directions, momentum_factors, nu, params, fp,
                 mass_msun, camera_x, log_j_scale, fallback_nan, integrator):
    global LAUNCHES
    lib = _library()
    device = positions.device
    b = positions.shape[0]
    prm = torch.tensor(kernel_params(params, fp, nu, mass_msun, camera_x,
                                     log_j_scale, fallback_nan),
                       dtype=torch.float64, device=device)
    i_nu = torch.empty(b, dtype=positions.dtype, device=device)
    flags = torch.empty(b, dtype=torch.int32, device=device)
    n_samples = torch.empty(b, dtype=torch.int32, device=device)
    if b:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.blacklight_formula_launch(
                _DTYPE_CODES[positions.dtype], INTEGRATORS.index(integrator),
                positions.data_ptr(), directions.data_ptr(),
                momentum_factors.data_ptr(), prm.data_ptr(), i_nu.data_ptr(),
                flags.data_ptr(), n_samples.data_ptr(), b, stream)
        if rc != 0:
            msg = lib.blacklight_cuda_error_string(rc).decode()
            raise RuntimeError(f"formula kernel launch failed: {msg} ({rc})")
        LAUNCHES += 1
    return i_nu[:, None], flags.bool(), n_samples


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with the C interface of csrc/formula_kernel.cu
    declared: every pointer and the stream as c_void_p."""
    lib = _build.load_library()
    ptr = ctypes.c_void_p
    lib.blacklight_formula_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_longlong, ptr]
    lib.blacklight_formula_launch.restype = ctypes.c_int
    lib.blacklight_formula_param_count.argtypes = []
    lib.blacklight_formula_param_count.restype = ctypes.c_int
    lib.blacklight_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blacklight_cuda_error_string.restype = ctypes.c_char_p
    if lib.blacklight_formula_param_count() != len(PARAM_NAMES):
        raise RuntimeError("csrc/formula_params.cuh and PARAM_NAMES disagree")
    return lib


def render_formula_reference(positions, directions, momentum_factors,
                             frequency: float, params: geo.GeodesicParams,
                             fp: FormulaParams, mass_msun: float, camera_x,
                             log_j_scale: float, fallback_nan: bool = True,
                             integrator: str = "dp"):
    """The kernel's function in plain torch ops over (B,) tensors.

    Every ray advances in lock step, as in the Pallas block: masks select
    the state updates, dead rays park at a benign state, and the loop runs
    while any ray is alive and n < max_steps. The JAX kernel's forms are
    kept, where-guards included. Returns what ``render_formula`` returns.
    """
    _check_rays(positions, directions, momentum_factors)
    nu = float(frequency)
    spin, mass, flat = params.bh_a, params.bh_m, params.ray_flat
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    i_scale = math.exp(log_j_scale + 3.0 * math.log(nu))
    max_steps = params.ray_max_steps
    cam = tuple(float(v) for v in camera_x)
    dp = integrator == "dp"
    mom = momentum_factors
    x0, x1, x2, x3 = positions.unbind(-1)
    p0, p1, p2, p3 = directions.unbind(-1)
    zero = torch.zeros_like(x0)
    false = torch.zeros_like(x0, dtype=torch.bool)
    izero = torch.zeros_like(x0, dtype=torch.int32)

    def rhs(y, with_distance=False):
        return geodesic_rhs_c(y[1], y[2], y[3], p0, y[4], y[5], y[6], spin,
                              mass, flat=flat, with_distance=with_distance)

    def renorm(y):
        return renormalize_factor_c(y[1], y[2], y[3], p0, y[4], y[5], y[6],
                                    spin, mass, flat=flat)

    def transfer(valid, bad, intensity, tau, ym, m1, m2, m3, h):
        sx1 = torch.where(valid, ym[1], cam[1])
        sx2 = torch.where(valid, ym[2], cam[2])
        sx3 = torch.where(valid, ym[3], cam[3])
        sx0 = torch.where(valid, ym[0], cam[0])
        sk0 = torch.where(valid, p0, -1.0)
        sk1 = torch.where(valid, m1, 1.0)
        sk2 = torch.where(valid, m2, 0.0)
        sk3 = torch.where(valid, m3, 0.0)
        keep, gbad, n_n0, u_dot_k = formula_geom_c(
            sx0, sx1, sx2, sx3, sk0, sk1, sk2, sk3, fp, cam)
        j, alpha, cbad = formula_jalpha_c(keep, gbad, n_n0, u_dot_k, mom,
                                          nu, fp)
        cbad = cbad | ~(torch.isfinite(j) & torch.isfinite(alpha))
        j = torch.where(cbad, 0.0, j)
        alpha = torch.where(cbad, 0.0, alpha)
        bad = bad | (valid & cbad)

        dl_cgs = torch.where(valid, -h, 0.0) * (x_unit / nu) / mom
        pos_alpha = alpha > 0.0
        ss = j / torch.where(pos_alpha, alpha, 1.0)
        delta_tau = alpha * dl_cgs
        atten = torch.exp(-tau)
        thin = delta_tau <= DELTA_TAU_MAX
        em = -torch.expm1(-delta_tau)
        contrib = torch.where(pos_alpha, torch.where(thin, ss * em, ss),
                              j * dl_cgs)
        intensity = intensity + torch.where(valid, contrib * atten, 0.0)
        dtau_eff = torch.where(pos_alpha,
                               torch.where(thin, delta_tau, math.inf), 0.0)
        tau = tau + torch.where(valid, dtau_eff, 0.0)
        return bad, intensity, tau

    def add_stage(base, weights, k, h):
        out = []
        for ci in range(7):
            acc = None
            for q, w in enumerate(weights):
                if w == 0.0:
                    continue
                term = (w * h) * k[q][ci]
                acc = term if acc is None else acc + term
            out.append(base[ci] if acc is None else base[ci] + acc)
        return out

    y = [x0, x1, x2, x3, p1, p2, p3]
    h_state = -params.ray_step * radius_c(x1, x2, x3, spin)
    alive = ~false
    trunc, flag, bad, prev_fail = false, false, false, false
    r_mid_prev, intensity, tau = zero, zero, zero
    n_samp, num_retry = izero, izero

    n = 0
    while n < max_steps and bool(alive.any()):
        r = radius_c(y[1], y[2], y[3], spin)
        if dp:
            k = [None] * 7
            k[0] = rhs(y, with_distance=True)
            ds_dlam = torch.abs(k[0][7]) + 1e-30
            h_cap = params.ray_step * r / ds_dlam
            h = -torch.minimum(torch.abs(h_state), h_cap)
            for i in range(1, 7):
                k[i] = rhs(add_stage(y, geo.DP_A[i], k, h))
            y_end = add_stage(y, geo.DP_B5, k, h)
            y4 = add_stage(y, geo.DP_B4, k, h)
            y_mid = add_stage(y, geo.DP_B4M, k, h)

            err = zero
            for ci in range(7):
                ya = torch.maximum(torch.abs(y[ci]), torch.abs(y_end[ci]))
                sc = params.ray_tol_abs + params.ray_tol_rel * ya
                err = torch.maximum(err, torch.abs(y_end[ci] - y4[ci]) / sc)
            accept = err <= 1.0
            err_safe = torch.clamp(err, min=1e-30)
            fac_ideal = geo.DP_ERR_FACTOR * err_safe ** (-geo.DP_ERR_POWER)
            fac_rej = torch.clamp(
                torch.where(torch.isfinite(err), fac_ideal,
                            geo.DP_MIN_FACTOR), min=geo.DP_MIN_FACTOR)
            fac_acc = torch.clamp(fac_ideal, geo.DP_MIN_FACTOR,
                                  geo.DP_MAX_FACTOR)
            fac_acc = torch.where(err == 0.0, geo.DP_MAX_FACTOR, fac_acc)
            fac_acc = torch.where(prev_fail, torch.clamp(fac_acc, max=1.0),
                                  fac_acc)
            h_next = h * torch.where(accept, fac_acc, fac_rej)
            retry = torch.where(accept, 0, num_retry + 1)
            retry_exceeded = retry > params.ray_max_retries
        else:
            h = torch.where(alive, -params.ray_step * (r - params.r_horizon),
                            0.0)
            k1 = rhs(y)
            if integrator == "rk4":
                k2 = rhs([y[c] + (0.5 * h) * k1[c] for c in range(7)])
                k3 = rhs([y[c] + (0.5 * h) * k2[c] for c in range(7)])
                k4 = rhs([y[c] + (1.0 * h) * k3[c] for c in range(7)])
                y_end = [y[c] + h * (k1[c] * (1.0 / 6.0) + k2[c] * (1.0 / 3.0)
                                     + k3[c] * (1.0 / 3.0)
                                     + k4[c] * (1.0 / 6.0))
                         for c in range(7)]
                y_mid = [0.5 * (y[c] + y_end[c]) for c in range(7)]
            else:  # rk2 (Heun); the sample is y + h/2 k1
                k2 = rhs([y[c] + (1.0 * h) * k1[c] for c in range(7)])
                y_end = [y[c] + 0.5 * h * (k1[c] + k2[c]) for c in range(7)]
                y_mid = [y[c] + (0.5 * h) * k1[c] for c in range(7)]
            accept = ~false
            retry_exceeded = false

        fac = renorm(y_end)
        r_new = radius_c(y_end[1], y_end[2], y_end[3], spin)
        facm = renorm(y_mid)
        r_mid = radius_c(y_mid[1], y_mid[2], y_mid[3], spin)

        trunc_now = (n_samp > 0) & (
            ((r_mid > params.camera_r) & (r_mid > r_mid_prev))
            | (r_mid < params.r_terminate))
        trunc = trunc | (accept & trunc_now)
        valid = alive & accept & ~trunc & ~retry_exceeded
        terminate = ((r_new > params.camera_r) & (r_new > r)) \
            | (r_new < params.r_terminate)
        flag = flag | (alive & retry_exceeded) \
            | (alive & accept & ~terminate & (n == max_steps - 1))
        alive_new = alive & ~(accept & terminate) & ~retry_exceeded

        bad, intensity, tau = transfer(
            valid, bad, intensity, tau, y_mid, y_mid[4] * facm,
            y_mid[5] * facm, y_mid[6] * facm, h)

        step = alive & accept
        park = ~alive_new
        stepped = [y_end[0], y_end[1], y_end[2], y_end[3],
                   y_end[4] * fac, y_end[5] * fac, y_end[6] * fac]
        parked = (0.0, 1.0e3, 0.0, 0.0, 1.0, 0.0, 0.0)
        y = [torch.where(park, parked[c], torch.where(step, stepped[c], y[c]))
             for c in range(7)]
        if dp:
            h_state = torch.where(alive, h_next, h_state)
            num_retry = torch.where(alive, retry, num_retry)
            prev_fail = (alive & ~accept) | (~alive & prev_fail)
        r_mid_prev = torch.where(valid, r_mid, r_mid_prev)
        n_samp = n_samp + valid.to(torch.int32)
        alive = alive_new
        n += 1

    poison = bad | flag if fallback_nan else bad
    i_nu = torch.where(poison, math.nan, intensity * i_scale)
    return i_nu[:, None], flag, n_samp
