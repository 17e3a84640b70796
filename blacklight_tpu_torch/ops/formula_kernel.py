"""Fused formula-model kernel: geodesics + coefficients + unpolarized
transfer, at one or several frequencies, with forward tangents of the
emission parameters where asked.

Port of ``blacklight_tpu/ops/pallas_formula.py`` (``_make_kernel``
:192-596, ``render_formula`` :599-697): any number of frequencies (K1.3)
and the in-kernel tangents dI/dp for any subset of ("cn0", "r0", "h")
(K1.4). The differentiable renderers built on the tangents are in
``ops/formula_fit``.

``render_formula`` dispatches on the device of the tensors it is given: on
a CUDA device it launches the hand-written kernel
(``csrc/formula_kernel.cuh``) or raises; on the CPU it runs
``render_formula_reference``, the same function in plain torch ops. There
is no fallback from one to the other.

A launch hands the kernel its constants by value (``launch_consts``: the
parameter vector rounded once to the rays' type on the host), a zeroed
slot counter and a grid of at most the card's resident blocks
(``persistent_grid``): each thread traces rays one after another, taking
the next ray from the counter when its ray ends, in the bundle's order.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
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
from blacklight_tpu_torch.transfer.unpolarized import DELTA_TAU_MAX

INTEGRATORS = ("dp", "rk4", "rk2")
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
# The parameters that can carry tangents, in the order of their outputs
# (the DiffParam enum of csrc/formula_kernel.cuh).
DIFFABLE_PARAMS = ("cn0", "r0", "h")
# Frequencies one launch takes (FORMULA_MAX_FREQUENCIES of
# csrc/formula_kernel.cuh): the kernel keeps one frequency's or up to this
# many frequencies' accumulators in registers; render_formula launches
# once per this many frequencies, each launch retracing the rays.
MAX_FREQUENCIES = 4

# Threads per block of the kernel (THREADS of csrc/formula_kernel.cuh).
THREADS = 128

# Kernel launches so far; render_formula adds one per launch of the CUDA
# kernel and nowhere else.
LAUNCHES = 0
# Calls of the plain version so far (render_formula_reference adds one per
# call): a run on the card shows with it that the plain version did not
# stand in for the kernel.
PLAIN_CALLS = 0

# Index order of the kernel's parameter vector: the enums in
# csrc/formula_params.cuh with their "P_" and "PF_" prefixes dropped, the
# fixed block and then one FREQUENCY_PARAM_NAMES block per frequency.
PARAM_NAMES = geo.GEODESIC_PARAM_NAMES + (
    "F_BH_A", "F_A2", "F_TWO_A", "F_TWO_M", "F_NEG_TWO_M_A", "F_CAMERA_R",
    "F_L0", "F_ONE_PLUS_Q", "F_INV_R0_SQ", "F_H_SQ", "F_INV_NUP",
    "F_A_PARAM",
    "F_CN0", "EJ", "EJ_IS_INT", "EJ_SIGN", "EA", "EA_IS_INT", "EA_SIGN",
) + CUT_PARAM_NAMES + ("CAM_X0", "CAM_X1", "CAM_X2", "CAM_X3")
FREQUENCY_PARAM_NAMES = ("NU", "X_UNIT_OVER_NU", "I_SCALE")


def kernel_params(params: geo.GeodesicParams, fp: FormulaParams, nus,
                  mass_msun: float, camera_x, log_j_scale: float,
                  fallback_nan: bool) -> list:
    """The kernel's parameter vector: PARAM_NAMES, then
    FREQUENCY_PARAM_NAMES for each frequency of ``nus`` (Python floats),
    every derived constant computed here in float64 (the kernel rounds
    each once to its working type, as JAX rounds a Python scalar)."""
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
        "CAM_X3": cam[3],
    })
    values.update(cut_param_values(GeometricCuts(
        camera_r=fp.camera_r, omit_near=fp.cut_omit_near,
        omit_far=fp.cut_omit_far, omit_in=fp.cut_omit_in,
        omit_out=fp.cut_omit_out, midplane_theta=fp.cut_midplane_theta,
        midplane_z=fp.cut_midplane_z, plane=fp.cut_plane,
        plane_origin=fp.cut_plane_origin, plane_normal=fp.cut_plane_normal)))
    out = geo.pack_params(PARAM_NAMES, values)
    for nu in nus:
        out += geo.pack_params(FREQUENCY_PARAM_NAMES, {
            "NU": nu, "X_UNIT_OVER_NU": x_unit / nu,
            "I_SCALE": image_scale(nu, log_j_scale)})
    return out


def frequency_bucket(nf: int) -> int:
    """The compile-time frequency bucket of a launch of nf frequencies
    (csrc/formula_kernel.cuh NF): 1, or MAX_FREQUENCIES."""
    if not 1 <= nf <= MAX_FREQUENCIES:
        raise ValueError(f"a launch takes 1..{MAX_FREQUENCIES} frequencies")
    return 1 if nf == 1 else MAX_FREQUENCIES


def launch_consts(values, dtype: torch.dtype) -> np.ndarray:
    """The kernel's launch constants (FormulaLaunchConsts) as the host
    packs them: ``values`` (kernel_params for one launch's frequencies)
    rounded once to the rays' dtype, the frequency blocks of the launch's
    bucket beyond its own frequencies zero. numpy rounds float64 to
    float32 to nearest, as the card's conversion does."""
    nf, rest = divmod(len(values) - len(PARAM_NAMES),
                      len(FREQUENCY_PARAM_NAMES))
    if rest:
        raise ValueError("values hold no whole number of frequency blocks")
    size = len(PARAM_NAMES) + frequency_bucket(nf) * len(FREQUENCY_PARAM_NAMES)
    out = np.zeros(size, dtype=_NUMPY_DTYPES[dtype])
    out[:len(values)] = np.asarray(values, dtype=np.float64)
    return out


def persistent_grid(n_rays: int, resident_blocks: int) -> int:
    """Blocks of a launch over n_rays rays: the card's resident blocks, or
    as many as the rays fill if fewer (0 for no rays)."""
    return min(resident_blocks, -(-n_rays // THREADS))


def image_scale(nu: float, log_j_scale: float) -> float:
    """Factor from the scaled transfer sum to I_nu at frequency nu, formed
    in float64 on the host: cn0/nup^2 alone (~1e-41) underflows float32."""
    return math.exp(log_j_scale + 3.0 * math.log(nu))


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


def frequency_list(frequencies) -> list:
    """The image frequencies as Python floats from a scalar, a sequence or
    a tensor (a tensor on the card is read back once)."""
    if isinstance(frequencies, torch.Tensor):
        frequencies = frequencies.detach().cpu().numpy()
    nus = [float(v) for v in np.ravel(np.asarray(frequencies, np.float64))]
    if not nus:
        raise ValueError("expected one or more frequencies")
    return nus


def _theta(diff_values, cn0, positions):
    """(names, values): the differentiated parameters in DIFFABLE_PARAMS
    order and their values as one (nd,) tensor in the rays' dtype and on
    their device (differentiable where the values are)."""
    if cn0 is not None:
        if diff_values is not None:
            raise ValueError("give cn0 or diff_values, not both")
        diff_values = {"cn0": cn0}
    if diff_values is None:
        return (), None
    unknown = set(diff_values) - set(DIFFABLE_PARAMS)
    if unknown or not diff_values:
        raise ValueError(f"diff_values takes a non-empty subset of "
                         f"{DIFFABLE_PARAMS}, not {sorted(diff_values)}")
    names = tuple(p for p in DIFFABLE_PARAMS if p in diff_values)
    values = torch.stack([
        torch.as_tensor(diff_values[p], dtype=positions.dtype,
                        device=positions.device).reshape(())
        for p in names])
    return names, values


def render_formula(positions, directions, momentum_factors, frequencies,
                   params: geo.GeodesicParams, fp: FormulaParams,
                   mass_msun: float, camera_x, log_j_scale: float,
                   fallback_nan: bool = True, integrator: str = "dp",
                   cn0=None, diff_values=None):
    """Fused render of a ray bundle.

    Args:
      positions, directions: (B, 4) camera rays (covariant momenta), float32
        or float64, contiguous; momentum_factors: (B,).
      frequencies: image frequencies in Hz: a scalar, a sequence or a
        tensor of F values. params / fp: geodesic and formula parameters.
        camera_x: the camera position (4 values).
      log_j_scale: models.formula.formula_log_j_scale(fp).
      integrator: "dp", "rk4" or "rk2".
      cn0: shorthand for diff_values={"cn0": cn0}.
      diff_values: a dict from a subset of ("cn0", "r0", "h") to runtime
        values (floats or 0-dim tensors, taken in the rays' dtype) that
        replace fp's in the coefficients; the kernel then also carries the
        forward tangent dI/dp of each.

    Returns (I_nu (B, F), flags (B,) bool, n_samples (B,) int32), and with
    diff_values a list of dI_nu/dp, one (B, F) tensor per parameter in
    ("cn0", "r0", "h") order, zero on poisoned pixels; on the rays' device
    and in their dtype. A scalar frequency gives F = 1: I_nu is (B, 1)
    where the JAX function returns (B,). dI/dcn0 is the tangent through
    alpha only (the amplitude cn0/nup^2 in log_j_scale is fixed here; the
    fit renderers of ops/formula_fit add it). A CUDA device runs the CUDA
    kernel; the CPU runs ``render_formula_reference``.
    """
    _check_rays(positions, directions, momentum_factors)
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator must be one of {INTEGRATORS}")
    nus = frequency_list(frequencies)
    names, theta = _theta(diff_values, cn0, positions)
    device = positions.device
    if device.type == "cuda":
        return _render_cuda(positions, directions, momentum_factors, nus,
                            params, fp, mass_msun, camera_x, log_j_scale,
                            fallback_nan, integrator, names, theta)
    if device.type == "cpu":
        return render_formula_reference(
            positions, directions, momentum_factors, nus, params, fp,
            mass_msun, camera_x, log_j_scale, fallback_nan=fallback_nan,
            integrator=integrator, cn0=cn0, diff_values=diff_values)
    raise ValueError(f"no formula kernel for device {device}")


def _render_cuda(positions, directions, momentum_factors, nus, params, fp,
                 mass_msun, camera_x, log_j_scale, fallback_nan, integrator,
                 names, theta):
    """One launch per MAX_FREQUENCIES frequencies, each writing its columns
    of I_nu (and of every dI/dp plane); every launch traces the same rays,
    so the flags and sample counts of the last stand. The launch constants
    go by value from the host; theta stays on the card, where the kernel
    reads it, so a fit step never waits on the host. Each launch takes its
    own zeroed slot counter."""
    global LAUNCHES
    lib = _library()
    device, dtype = positions.device, positions.dtype
    b, nf, nd = positions.shape[0], len(nus), len(names)
    mask = sum(1 << DIFFABLE_PARAMS.index(p) for p in names)
    i_nu = torch.empty((b, nf), dtype=dtype, device=device)
    d_i_nu = torch.empty((nd, b, nf), dtype=dtype, device=device)
    flags = torch.empty(b, dtype=torch.int32, device=device)
    n_samples = torch.empty(b, dtype=torch.int32, device=device)
    if theta is not None:
        theta = theta.detach().contiguous()
    starts = range(0, nf if b else 0, MAX_FREQUENCIES)
    next_slots = torch.zeros(len(starts), dtype=torch.int64, device=device)
    item = i_nu.element_size()
    for launch, start in enumerate(starts):
        chunk = nus[start:start + MAX_FREQUENCIES]
        consts = launch_consts(kernel_params(
            params, fp, chunk, mass_msun, camera_x, log_j_scale,
            fallback_nan), dtype)
        code, integ = _DTYPE_CODES[dtype], INTEGRATORS.index(integrator)
        with torch.cuda.device(device):
            grid = persistent_grid(b, _resident_blocks(
                device.index, code, integ, len(chunk), mask))
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.blacklight_formula_launch(
                code, integ, len(chunk), mask, positions.data_ptr(),
                directions.data_ptr(), momentum_factors.data_ptr(),
                consts.ctypes.data, consts.nbytes,
                theta.data_ptr() if nd else None,
                next_slots[launch:].data_ptr(), grid,
                i_nu.data_ptr() + start * item,
                d_i_nu.data_ptr() + start * item if nd else None, nf,
                flags.data_ptr(), n_samples.data_ptr(), b, stream)
        if rc != 0:
            msg = lib.blacklight_cuda_error_string(rc).decode()
            raise RuntimeError(f"formula kernel launch failed: {msg} ({rc})")
        LAUNCHES += 1
    if not nd:
        return i_nu, flags.bool(), n_samples
    return i_nu, flags.bool(), n_samples, list(d_i_nu.unbind(0))


@functools.cache
def _resident_blocks(device_index, dtype_code, integrator, nf, mask) -> int:
    """Blocks of the instantiation a launch takes that the current card
    holds at once (blocks per SM times SMs)."""
    blocks = ctypes.c_int(0)
    rc = _library().blacklight_formula_resident_blocks(
        dtype_code, integrator, nf, mask, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        msg = _library().blacklight_cuda_error_string(rc).decode()
        raise RuntimeError(f"formula kernel occupancy query failed: {msg} "
                           f"({rc}, {blocks.value} blocks)")
    return blocks.value


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with the C interface of csrc/formula_kernel.cu
    declared: every pointer and the stream as c_void_p."""
    lib = _build.load_library()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.blacklight_formula_launch.argtypes = [
        i32, i32, i32, i32, ptr, ptr, ptr, ptr, i64, ptr, ptr, i32, ptr, ptr,
        i32, ptr, ptr, i64, ptr]
    lib.blacklight_formula_launch.restype = i32
    lib.blacklight_formula_resident_blocks.argtypes = [
        i32, i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.blacklight_formula_resident_blocks.restype = i32
    lib.blacklight_formula_consts_bytes.argtypes = [i32, i32]
    lib.blacklight_formula_consts_bytes.restype = i64
    for name in ("blacklight_formula_param_count",
                 "blacklight_formula_frequency_param_count",
                 "blacklight_formula_max_frequencies",
                 "blacklight_formula_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.blacklight_cuda_error_string.argtypes = [i32]
    lib.blacklight_cuda_error_string.restype = ctypes.c_char_p
    if (lib.blacklight_formula_param_count() != len(PARAM_NAMES)
            or lib.blacklight_formula_frequency_param_count()
            != len(FREQUENCY_PARAM_NAMES)):
        raise RuntimeError("csrc/formula_params.cuh and PARAM_NAMES disagree")
    if (lib.blacklight_formula_max_frequencies() != MAX_FREQUENCIES
            or lib.blacklight_formula_threads() != THREADS):
        raise RuntimeError("csrc/formula_kernel.cuh and MAX_FREQUENCIES or "
                           "THREADS disagree")
    if consts_sizes(lib) != host_consts_sizes():
        raise RuntimeError("FormulaLaunchConsts and launch_consts disagree: "
                           f"{consts_sizes(lib)} != {host_consts_sizes()}")
    return lib


def consts_sizes(lib) -> dict:
    """sizeof(FormulaLaunchConsts) per (dtype, frequency bucket), from the
    C side."""
    return {(dtype, bucket): lib.blacklight_formula_consts_bytes(code, bucket)
            for dtype, code in _DTYPE_CODES.items()
            for bucket in (1, MAX_FREQUENCIES)}


def host_consts_sizes() -> dict:
    """The bytes launch_consts packs per (dtype, frequency bucket)."""
    values = [0.0] * (len(PARAM_NAMES) + len(FREQUENCY_PARAM_NAMES))
    sizes = {}
    for dtype in _DTYPE_CODES:
        for bucket in (1, MAX_FREQUENCIES):
            blocks = values + [0.0] * len(FREQUENCY_PARAM_NAMES) * (bucket - 1)
            sizes[dtype, bucket] = launch_consts(blocks, dtype).nbytes
    return sizes


def render_formula_reference(positions, directions, momentum_factors,
                             frequencies, params: geo.GeodesicParams,
                             fp: FormulaParams, mass_msun: float, camera_x,
                             log_j_scale: float, fallback_nan: bool = True,
                             integrator: str = "dp", cn0=None,
                             diff_values=None):
    """The kernel's function in plain torch ops over (B,) tensors: the
    shared lock-step loop (``geodesic.trace_reference``) with the formula
    coefficients, the transfer update and the forward tangents at every
    sample, in the kernel's operation forms. Returns what
    ``render_formula`` returns. The values of diff_values enter as they
    are (in the rays' dtype), so autograd reaches them through the
    intensities as well as through the tangents.
    """
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    _check_rays(positions, directions, momentum_factors)
    nus = frequency_list(frequencies)
    names, theta = _theta(diff_values, cn0, positions)
    rt = dict(zip(names, theta)) if names else {}
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    cam = tuple(float(v) for v in camera_x)
    mom = momentum_factors
    zero = torch.zeros_like(mom)
    acc = {"bad": torch.zeros_like(mom, dtype=torch.bool)}
    for f in range(len(nus)):
        acc[f"I{f}"] = acc[f"tau{f}"] = zero
        for p in names:
            acc[f"dI_{p}{f}"] = acc[f"dtau_{p}{f}"] = zero

    def transfer(valid, ym, k, h):
        sx0, sx1, sx2, sx3 = (torch.where(valid, ym[c], cam[c])
                              for c in range(4))
        sk0 = torch.where(valid, k[0], -1.0)
        sk1 = torch.where(valid, k[1], 1.0)
        sk2 = torch.where(valid, k[2], 0.0)
        sk3 = torch.where(valid, k[3], 0.0)
        keep, gbad, n_n0, u_dot_k, r, cth = formula_geom_c(
            sx0, sx1, sx2, sx3, sk0, sk1, sk2, sk3, fp, cam,
            r0=rt.get("r0"), h=rt.get("h"))
        # log-derivatives of the density profile wrt r0 and h
        weights = {}
        if "r0" in rt:
            weights["r0"] = r * r / (rt["r0"] * rt["r0"] * rt["r0"])
        if "h" in rt:
            weights["h"] = -rt["h"] * cth * cth
        for f, nu in enumerate(nus):
            j, alpha, cbad, alpha_unit = formula_jalpha_c(
                keep, gbad, n_n0, u_dot_k, mom, nu, fp, cn0=rt.get("cn0"),
                with_unit=True)
            cbad = cbad | ~(torch.isfinite(j) & torch.isfinite(alpha))
            j = torch.where(cbad, 0.0, j)
            alpha = torch.where(cbad, 0.0, alpha)
            # one bad mask for all frequencies, as the TPU kernel keeps it
            acc["bad"] = acc["bad"] | (valid & cbad)

            dl_cgs = torch.where(valid, -h, 0.0) * (x_unit / nu) / mom
            pos_alpha = alpha > 0.0
            ss = j / torch.where(pos_alpha, alpha, 1.0)
            delta_tau = alpha * dl_cgs
            atten = torch.exp(-acc[f"tau{f}"])
            thin = delta_tau <= DELTA_TAU_MAX
            em = -torch.expm1(-delta_tau)
            contrib = torch.where(pos_alpha, torch.where(thin, ss * em, ss),
                                  j * dl_cgs)
            if names:
                # dss divides by alpha rather than multiply by 1 / alpha
                # (the TPU kernel's form): a subnormal float32 alpha in
                # the disk's Gaussian tail has an overflowing reciprocal
                alpha_or_1 = torch.where(pos_alpha, alpha, 1.0)
                exp_neg_dt = torch.exp(-delta_tau)
            for p in names:
                # tangent of (j, alpha): j does not depend on cn0
                if p == "cn0":
                    dalpha = torch.where(cbad, 0.0, alpha_unit)
                    ddt = dalpha * dl_cgs
                    dss = -ss * dalpha / alpha_or_1
                    off = 0.0
                else:
                    dj = j * weights[p]
                    dalpha = alpha * weights[p]
                    ddt = dalpha * dl_cgs
                    dss = (dj - ss * dalpha) / alpha_or_1
                    off = dj * dl_cgs
                dcontrib = torch.where(
                    pos_alpha,
                    torch.where(thin, dss * em + ss * exp_neg_dt * ddt, dss),
                    off)
                # tau == inf => atten == 0: later contributions and their
                # tangents vanish (the guard avoids 0 * inf)
                datten = torch.where(atten > 0.0,
                                     -atten * acc[f"dtau_{p}{f}"], 0.0)
                acc[f"dI_{p}{f}"] = acc[f"dI_{p}{f}"] + torch.where(
                    valid, dcontrib * atten + contrib * datten, 0.0)
                acc[f"dtau_{p}{f}"] = acc[f"dtau_{p}{f}"] + torch.where(
                    valid & pos_alpha & thin, ddt, 0.0)
            acc[f"I{f}"] = acc[f"I{f}"] + torch.where(
                valid, contrib * atten, 0.0)
            dtau_eff = torch.where(pos_alpha,
                                   torch.where(thin, delta_tau, math.inf),
                                   0.0)
            acc[f"tau{f}"] = acc[f"tau{f}"] + torch.where(valid, dtau_eff,
                                                          0.0)

    flag, n_samp = geo.trace_reference(positions, directions, params,
                                       integrator, transfer)
    poison = acc["bad"] | flag if fallback_nan else acc["bad"]
    scales = [image_scale(nu, log_j_scale) for nu in nus]
    i_nu = torch.stack([torch.where(poison, math.nan, acc[f"I{f}"] * s)
                        for f, s in enumerate(scales)], dim=-1)
    if not names:
        return i_nu, flag, n_samp
    # a poisoned pixel holds a constant NaN: its derivative is zero
    d_i_nu = [torch.stack([torch.where(poison, 0.0, acc[f"dI_{p}{f}"] * s)
                           for f, s in enumerate(scales)], dim=-1)
              for p in names]
    return i_nu, flag, n_samp, d_i_nu
