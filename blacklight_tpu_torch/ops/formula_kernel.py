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

from blacklight_tpu_torch.constants import Physics
from blacklight_tpu_torch.models.cuts import (
    CUT_PARAM_NAMES,
    GeometricCuts,
    cut_param_values,
)
from blacklight_tpu_torch.models.formula import (
    FormulaParams,
    cpp_pow_exponent,
    formula_geom_c,
    formula_jalpha_c,
)
from blacklight_tpu_torch.ops import _build
from blacklight_tpu_torch.ops import geodesic as geo

DELTA_TAU_MAX = 100.0
INTEGRATORS = ("dp", "rk4", "rk2")
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

# Kernel launches so far; render_formula adds one per launch of the CUDA
# kernel and nowhere else.
LAUNCHES = 0

# Index order of the kernel's float64 parameter vector: the enum in
# csrc/formula_params.cuh with its "P_" prefix dropped.
PARAM_NAMES = geo.GEODESIC_PARAM_NAMES + (
    "F_BH_A", "F_A2", "F_TWO_A", "F_TWO_M", "F_NEG_TWO_M_A", "F_CAMERA_R",
    "F_L0", "F_ONE_PLUS_Q", "F_INV_R0_SQ", "F_H_SQ", "F_INV_NUP",
    "F_A_PARAM",
    "F_CN0", "EJ", "EJ_IS_INT", "EJ_SIGN", "EA", "EA_IS_INT", "EA_SIGN",
) + CUT_PARAM_NAMES + (
    "CAM_X0", "CAM_X1", "CAM_X2", "CAM_X3", "NU",
    "X_UNIT_OVER_NU", "I_SCALE",
)


def kernel_params(params: geo.GeodesicParams, fp: FormulaParams, nu: float,
                  mass_msun: float, camera_x, log_j_scale: float,
                  fallback_nan: bool) -> list:
    """The kernel's parameter vector in PARAM_NAMES order, every derived
    constant computed here in float64 (the kernel rounds each once to its
    working type, as JAX rounds a Python scalar)."""
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    ej = -fp.alpha - 2.0
    ea = -fp.beta - fp.alpha
    ej_int, ej_sign = cpp_pow_exponent(ej)
    ea_int, ea_sign = cpp_pow_exponent(ea)
    cam = [float(v) for v in camera_x]
    values = geo.geodesic_param_values(params, fallback_nan)
    values.update({
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
        "CAM_X0": cam[0], "CAM_X1": cam[1], "CAM_X2": cam[2],
        "CAM_X3": cam[3], "NU": nu, "X_UNIT_OVER_NU": x_unit / nu,
        "I_SCALE": math.exp(log_j_scale + 3.0 * math.log(nu)),
    })
    values.update(cut_param_values(GeometricCuts(
        camera_r=fp.camera_r, omit_near=fp.cut_omit_near,
        omit_far=fp.cut_omit_far, omit_in=fp.cut_omit_in,
        omit_out=fp.cut_omit_out, midplane_theta=fp.cut_midplane_theta,
        midplane_z=fp.cut_midplane_z, plane=fp.cut_plane,
        plane_origin=fp.cut_plane_origin, plane_normal=fp.cut_plane_normal)))
    return geo.pack_params(PARAM_NAMES, values)


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
    """The kernel's function in plain torch ops over (B,) tensors: the
    shared lock-step loop (``geodesic.trace_reference``) with the formula
    coefficients and the transfer update at every sample. Returns what
    ``render_formula`` returns.
    """
    _check_rays(positions, directions, momentum_factors)
    nu = float(frequency)
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    i_scale = math.exp(log_j_scale + 3.0 * math.log(nu))
    cam = tuple(float(v) for v in camera_x)
    mom = momentum_factors
    zero = torch.zeros_like(mom)
    acc = {"bad": torch.zeros_like(mom, dtype=torch.bool),
           "intensity": zero, "tau": zero}

    def transfer(valid, ym, k, h):
        sx0, sx1, sx2, sx3 = (torch.where(valid, ym[c], cam[c])
                              for c in range(4))
        sk0 = torch.where(valid, k[0], -1.0)
        sk1 = torch.where(valid, k[1], 1.0)
        sk2 = torch.where(valid, k[2], 0.0)
        sk3 = torch.where(valid, k[3], 0.0)
        keep, gbad, n_n0, u_dot_k = formula_geom_c(
            sx0, sx1, sx2, sx3, sk0, sk1, sk2, sk3, fp, cam)
        j, alpha, cbad = formula_jalpha_c(keep, gbad, n_n0, u_dot_k, mom,
                                          nu, fp)
        cbad = cbad | ~(torch.isfinite(j) & torch.isfinite(alpha))
        j = torch.where(cbad, 0.0, j)
        alpha = torch.where(cbad, 0.0, alpha)
        acc["bad"] = acc["bad"] | (valid & cbad)

        dl_cgs = torch.where(valid, -h, 0.0) * (x_unit / nu) / mom
        pos_alpha = alpha > 0.0
        ss = j / torch.where(pos_alpha, alpha, 1.0)
        delta_tau = alpha * dl_cgs
        atten = torch.exp(-acc["tau"])
        thin = delta_tau <= DELTA_TAU_MAX
        em = -torch.expm1(-delta_tau)
        contrib = torch.where(pos_alpha, torch.where(thin, ss * em, ss),
                              j * dl_cgs)
        acc["intensity"] = acc["intensity"] + torch.where(
            valid, contrib * atten, 0.0)
        dtau_eff = torch.where(pos_alpha,
                               torch.where(thin, delta_tau, math.inf), 0.0)
        acc["tau"] = acc["tau"] + torch.where(valid, dtau_eff, 0.0)

    flag, n_samp = geo.trace_reference(positions, directions, params,
                                       integrator, transfer)
    poison = acc["bad"] | flag if fallback_nan else acc["bad"]
    i_nu = torch.where(poison, math.nan, acc["intensity"] * i_scale)
    return i_nu[:, None], flag, n_samp
