"""Fused simulation-model kernel: geodesics + GRMHD grid sampling +
thermal synchrotron coefficients + unpolarized transfer.

Port of ``blacklight_tpu/ops/pallas_simulation.py`` (``_make_kernel``
:795, launched by ``render_simulation`` :1400; K2.1 rk4/rk2 and K2.2
dp) for a single-block SKS grid, thermal ti_te_beta electrons and any
number of frequencies. The values follow the JAX package's exact (XLA)
path, ``pipeline_simulation.make_simulation_coeff_fns`` inside
``transfer/unpolarized.integrate_unpolarized``, in each dtype's forms.

``render_simulation`` dispatches on the device of the rays it is given:
on a CUDA device it launches the hand-written kernel
(``csrc/simulation_kernel.cuh``) or raises; on the CPU it runs
``render_simulation_reference``, the same function in plain torch ops
built from ``grid/sampling``, ``models/cuts`` and
``models/synchrotron``. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from blacklight_tpu_torch.constants import Math, Physics
from blacklight_tpu_torch.grid.athena import SimulationGrid
from blacklight_tpu_torch.grid.sampling import (
    SAMPLE_NAMES,
    SamplerOptions,
    sample_grid,
)
from blacklight_tpu_torch.models import synchrotron
from blacklight_tpu_torch.models.cuts import (
    CUT_PARAM_NAMES,
    GeometricCuts,
    cut_param_values,
    geometric_keep,
)
from blacklight_tpu_torch.ops import _build
from blacklight_tpu_torch.ops import geodesic as geo
from blacklight_tpu_torch.ops.formula_kernel import (
    DELTA_TAU_MAX,
    INTEGRATORS,
    _DTYPE_CODES,
    _check_rays,
)

# Frequencies one launch takes (csrc/simulation_kernel.cuh): one frequency
# keeps its accumulators in registers, more hold them in a local array.
# render_simulation launches once per this many frequencies.
MAX_FREQUENCIES = 16

# Kernel launches so far; render_simulation adds one per launch of the CUDA
# kernel and nowhere else.
LAUNCHES = 0

# Index order of the kernel's float64 parameter vector: the enum in
# csrc/simulation_params.cuh with its "S_" prefix dropped. The geodesic
# block comes first, then the geometric-cut block, in the orders
# csrc/trace.cuh and csrc/cuts.cuh read.
VALUE_CUT_NAMES = ("RHO", "N_E", "P_GAS", "THETA_E", "B", "SIGMA",
                   "BETA_INV")
PARAM_NAMES = geo.GEODESIC_PARAM_NAMES + CUT_PARAM_NAMES + (
    "D_UNIT", "E_UNIT", "B_UNIT", "MU_MP", "NE_DIV", "RAT_HIGH", "RAT_LOW",
    "KB_TOT", "USE_P", "ONE_PLUS_NE_NI", "NE_NI", "GAMMA_M1", "GAMMA_I_M1",
    "NE_NI_OVER_GAMMA_E_M1", "ME_C2",
) + tuple(f"{name}_{end}" for name in VALUE_CUT_NAMES
          for end in ("MIN", "MAX")) + (
    "THERMAL_FRAC", "E_CHARGE", "NU_C_DIV", "TWO_NINTHS", "VAR_A", "VAR_B",
    "H_PLANCK", "NU0", "KIRCHHOFF",
    "CAM_X1", "CAM_X2", "CAM_X3", "X_UNIT",
)


@dataclasses.dataclass(frozen=True)
class SimKernelParams:
    """Everything the kernel needs besides GeodesicParams, the rays and
    the grid: the plasma model, the value and geometric cuts, the
    sampler's options and the code density unit."""

    plasma: synchrotron.PlasmaParams
    cuts: synchrotron.CutParams
    geometric: GeometricCuts
    sampler: SamplerOptions
    rho_unit: float


def sim_kernel_params(cfg, cuts_geo: GeometricCuts,
                      plasma: synchrotron.PlasmaParams,
                      cuts_val: synchrotron.CutParams) -> SimKernelParams:
    return SimKernelParams(
        plasma=plasma, cuts=cuts_val, geometric=cuts_geo,
        sampler=SamplerOptions(
            fallback_nan=cfg.require("fallback_nan"),
            fallback_rho=cfg.fallback_rho or 0.0,
            fallback_pgas=cfg.fallback_pgas or 0.0),
        rho_unit=cfg.require("simulation_rho_cgs"))


def kernel_params(params: geo.GeodesicParams, sp: SimKernelParams,
                  nu0: float, mass_msun: float, camera_x) -> list:
    """The kernel's parameter vector in PARAM_NAMES order, every derived
    constant folded here in float64 as the JAX package folds it in
    Python before it meets an array."""
    pl = sp.plasma
    e_unit = sp.rho_unit * Physics.c ** 2
    values = geo.geodesic_param_values(params, sp.sampler.fallback_nan)
    values.update(cut_param_values(sp.geometric))
    values.update({
        "D_UNIT": sp.rho_unit, "E_UNIT": e_unit,
        "B_UNIT": math.sqrt(4.0 * Math.pi * e_unit),
        "MU_MP": pl.mu * Physics.m_p, "NE_DIV": 1.0 + 1.0 / pl.ne_ni,
        "RAT_HIGH": pl.rat_high, "RAT_LOW": pl.rat_low,
        "KB_TOT": pl.mu * Physics.m_p * Physics.c ** 2, "USE_P": pl.use_p,
        "ONE_PLUS_NE_NI": 1.0 + pl.ne_ni, "NE_NI": pl.ne_ni,
        "GAMMA_M1": pl.gamma - 1.0, "GAMMA_I_M1": pl.gamma_i - 1.0,
        "NE_NI_OVER_GAMMA_E_M1": pl.ne_ni / (pl.gamma_e - 1.0),
        "ME_C2": Physics.m_e * Physics.c ** 2,
        "THERMAL_FRAC": pl.thermal_frac, "E_CHARGE": Physics.e,
        "NU_C_DIV": 2.0 * Math.pi * Physics.m_e * Physics.c,
        "TWO_NINTHS": 2.0 / 9.0, "VAR_A": Math.sqrt2 * Math.pi / 27.0,
        "VAR_B": 2.0 ** (11.0 / 12.0), "H_PLANCK": Physics.h,
        "NU0": nu0, "KIRCHHOFF": math.exp(synchrotron.log_kirchhoff(nu0)),
        "CAM_X1": float(camera_x[1]), "CAM_X2": float(camera_x[2]),
        "CAM_X3": float(camera_x[3]),
        "X_UNIT": Physics.gg_msun * mass_msun / (Physics.c * Physics.c),
    })
    for name, (_, lo, hi) in zip(VALUE_CUT_NAMES, sp.cuts.pairs()):
        values[f"{name}_MIN"], values[f"{name}_MAX"] = lo, hi
    return geo.pack_params(PARAM_NAMES, values)


def check_grid(grid: SimulationGrid) -> None:
    """Raise ValueError for a grid outside the kernel's cover: one mesh
    block of at least 2 cells per axis, faces in non-decreasing order (the kernel's binary search then finds the
    cell the comparison count finds)."""
    if grid.n_blocks != 1:
        raise ValueError("the simulation kernel covers single-block grids")
    if min(grid.prim.shape[2:]) < 2:
        raise ValueError("the simulation kernel needs 2 cells per axis")
    for faces in (grid.x1f, grid.x2f, grid.x3f):
        if bool((faces[0, 1:] < faces[0, :-1]).any()):
            raise ValueError("grid faces must be non-decreasing")
    missing = [n for n in SAMPLE_NAMES if n not in grid.ind]
    if missing:
        raise ValueError(f"grid lacks {missing}")


def kernel_tables(grid: SimulationGrid, dtype):
    """The two tables the kernel reads from device memory.

    table: (n_k, n_j, n_i, 8) float32, the SAMPLE_NAMES primitives of a
      cell side by side (32 bytes, two 16-byte loads per corner);
    coords: x1f, x1v, x2f, x2v, x3f, x3v of the block, concatenated, in
      ``dtype``.
    Built on the grid's device at each launch (one pass over the table).
    """
    rows = torch.tensor([grid.ind[n] for n in SAMPLE_NAMES],
                        device=grid.prim.device)
    table = grid.prim[:, 0].index_select(0, rows).permute(1, 2, 3, 0)
    coords = torch.cat([c[0].to(dtype) for c in (
        grid.x1f, grid.x1v, grid.x2f, grid.x2v, grid.x3f, grid.x3v)])
    return table.contiguous(), coords.contiguous()


def render_simulation(positions, directions, momentum_factors, frequencies,
                      params: geo.GeodesicParams, sp: SimKernelParams,
                      grid: SimulationGrid, mass_msun: float, camera_x,
                      log_j_scale: float, integrator: str = "rk4"):
    """Fused render of a ray bundle through a GRMHD snapshot.

    Args:
      positions, directions: (B, 4) camera rays (covariant momenta),
        float32 or float64, contiguous; momentum_factors: (B,).
      frequencies: (F,) image frequencies in Hz, in the rays' dtype and
        on their device, F >= 1.
      params / sp: geodesic and simulation parameters; grid: the snapshot
        on the rays' device; camera_x: the camera position (4 values);
      log_j_scale: synchrotron.log_j_scale(frequencies[0]).
      integrator: "dp", "rk4" or "rk2".

    Returns (I_nu (B, F), flags (B,) bool, n_samples (B,) int32), on the
    rays' device and in their dtype. A CUDA device runs the CUDA kernel;
    the CPU runs ``render_simulation_reference``.
    """
    _check_rays(positions, directions, momentum_factors)
    _check_frequencies(frequencies, positions)
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator must be one of {INTEGRATORS}")
    check_grid(grid)
    if grid.prim.device != positions.device:
        raise TypeError("the grid and the rays must share one device")
    device = positions.device
    if device.type == "cuda":
        return _render_cuda(positions, directions, momentum_factors,
                            frequencies, params, sp, grid, mass_msun,
                            camera_x, log_j_scale, integrator)
    if device.type == "cpu":
        return render_simulation_reference(
            positions, directions, momentum_factors, frequencies, params, sp,
            grid, mass_msun, camera_x, log_j_scale, integrator=integrator)
    raise ValueError(f"no simulation kernel for device {device}")


def image_scale(frequencies, log_j_scale: float):
    """(F,) factor from the scaled transfer sums to I_nu: the unit scale
    with the nu^3 factor, formed in log space in the working dtype as
    integrate_unpolarized forms it (the unit alone, ~1e-41, underflows
    float32)."""
    return torch.exp(torch.tensor(log_j_scale, dtype=frequencies.dtype,
                                  device=frequencies.device)
                     + 3.0 * torch.log(frequencies))


def _check_frequencies(frequencies, positions):
    if frequencies.dim() != 1 or frequencies.shape[0] < 1:
        raise ValueError(f"expected 1 or more frequencies, got shape "
                         f"{tuple(frequencies.shape)}")
    if (frequencies.dtype != positions.dtype
            or frequencies.device != positions.device):
        raise TypeError("frequencies must share the rays' dtype and device")


def _render_cuda(positions, directions, momentum_factors, frequencies,
                 params, sp, grid, mass_msun, camera_x, log_j_scale,
                 integrator):
    """One launch per MAX_FREQUENCIES frequencies; every launch traces the
    same rays, so the flags and sample counts of the first stand. The
    temporaries (parameters, tables, frequencies) may be freed before the
    kernel ends: the caching allocator hands their memory only to work
    queued after it on the same stream."""
    global LAUNCHES
    lib = _library()
    device = positions.device
    b, nf = positions.shape[0], frequencies.shape[0]
    prm = torch.tensor(kernel_params(params, sp, float(frequencies[0]),
                                     mass_msun, camera_x),
                       dtype=torch.float64, device=device)
    table, coords = kernel_tables(grid, positions.dtype)
    n_k, n_j, n_i = table.shape[:3]
    scales = image_scale(frequencies, log_j_scale)
    i_nu = torch.empty((b, nf), dtype=positions.dtype, device=device)
    flags = torch.empty(b, dtype=torch.int32, device=device)
    n_samples = torch.empty(b, dtype=torch.int32, device=device)
    if not b:
        return i_nu, flags.bool(), n_samples
    for start in range(0, nf, MAX_FREQUENCIES):
        stop = min(start + MAX_FREQUENCIES, nf)
        freqs = torch.cat([frequencies[start:stop], scales[start:stop]])
        out = i_nu if stop - start == nf else torch.empty(
            (b, stop - start), dtype=positions.dtype, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.blacklight_simulation_launch(
                _DTYPE_CODES[positions.dtype], INTEGRATORS.index(integrator),
                positions.data_ptr(), directions.data_ptr(),
                momentum_factors.data_ptr(), freqs.data_ptr(), stop - start,
                prm.data_ptr(), table.data_ptr(), coords.data_ptr(), n_i,
                n_j, n_k, out.data_ptr(), flags.data_ptr(),
                n_samples.data_ptr(), b, stream)
        if rc != 0:
            msg = lib.blacklight_cuda_error_string(rc).decode()
            raise RuntimeError(f"simulation kernel launch failed: {msg} "
                               f"({rc})")
        LAUNCHES += 1
        if out is not i_nu:
            i_nu[:, start:stop] = out
    return i_nu, flags.bool(), n_samples


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with the C interface of csrc/simulation_kernel.cu
    declared: every pointer and the stream as c_void_p."""
    lib = _build.load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.blacklight_simulation_launch.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, i32, i32,
        ptr, ptr, ptr, ctypes.c_longlong, ptr]
    lib.blacklight_simulation_launch.restype = ctypes.c_int
    lib.blacklight_simulation_param_count.argtypes = []
    lib.blacklight_simulation_param_count.restype = ctypes.c_int
    lib.blacklight_simulation_max_frequencies.argtypes = []
    lib.blacklight_simulation_max_frequencies.restype = ctypes.c_int
    lib.blacklight_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blacklight_cuda_error_string.restype = ctypes.c_char_p
    if lib.blacklight_simulation_param_count() != len(PARAM_NAMES):
        raise RuntimeError("csrc/simulation_params.cuh and PARAM_NAMES "
                           "disagree")
    if lib.blacklight_simulation_max_frequencies() != MAX_FREQUENCIES:
        raise RuntimeError("csrc/simulation_kernel.cuh and MAX_FREQUENCIES "
                           "disagree")
    return lib


def sample_coefficients(pos, kcov, momentum_factors, frequencies,
                        sp: SimKernelParams, grid: SimulationGrid, spin,
                        camera_x, nu0: float):
    """Invariant j (scaled by exp(-log_j_scale)) and alpha, (B, F) each,
    and the (B, F) mask of samples the reference would NaN, at CKS
    positions ``pos`` (B, 4) with covariant momenta ``kcov`` (four (B,)
    components): make_simulation_coeff_fns' coeff_fn for the slice.
    Coefficients are zero where a cut holds or the field vanishes."""
    samples = sample_grid(grid, pos, spin, sp.sampler)
    keep_geo = geometric_keep(pos, spin, camera_x, sp.geometric)
    state = synchrotron.fluid_state(pos, samples, spin, sp.plasma,
                                    sp.rho_unit)
    keep_val = synchrotron.value_cuts(state, sp.cuts)
    b_zero = ((samples["bb1"] == 0.0) & (samples["bb2"] == 0.0)
              & (samples["bb3"] == 0.0))
    sin_b, _, _, u_dot_k = synchrotron.pitch_angle(kcov, state)
    nu_cgs = -u_dot_k[:, None] * frequencies[None, :] \
        * momentum_factors[:, None]
    j, alpha = synchrotron.thermal_coefficients(nu_cgs, nu0, state, sin_b,
                                                sp.plasma)
    keep = (keep_geo & keep_val & ~b_zero)[:, None]
    j = torch.where(keep, j, 0.0)
    alpha = torch.where(keep, alpha, 0.0)
    bad = (samples["nan_mask"] & keep_geo)[:, None].expand(j.shape)
    return j, alpha, bad


def render_simulation_reference(positions, directions, momentum_factors,
                                frequencies, params: geo.GeodesicParams,
                                sp: SimKernelParams, grid: SimulationGrid,
                                mass_msun: float, camera_x,
                                log_j_scale: float, integrator: str = "rk4"):
    """The kernel's function in plain torch ops: the shared lock-step loop
    (``geodesic.trace_reference``) with ``sample_coefficients`` and the
    transfer update of ``integrate_unpolarized`` at every sample. Returns
    what ``render_simulation`` returns."""
    _check_rays(positions, directions, momentum_factors)
    _check_frequencies(frequencies, positions)
    dtype = positions.dtype
    spin = params.bh_a
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    nu0 = float(frequencies[0])
    cam = [float(v) for v in camera_x]
    mom = momentum_factors
    b, nf = positions.shape[0], frequencies.shape[0]
    zero = torch.zeros((b, nf), dtype=dtype, device=positions.device)
    acc = {"bad": torch.zeros_like(zero, dtype=torch.bool),
           "intensity": zero, "tau": zero}

    def transfer(valid, ym, k, h):
        # Invalid samples hold dead rays' last state; evaluate them at the
        # camera instead (their values are discarded through valid)
        pos = torch.stack([torch.where(valid, ym[c], cam[c])
                           for c in range(4)], dim=-1)
        kcov = (torch.where(valid, k[0], -1.0), torch.where(valid, k[1], 1.0),
                torch.where(valid, k[2], 0.0), torch.where(valid, k[3], 0.0))
        j, alpha, cbad = sample_coefficients(
            pos, kcov, mom, frequencies, sp, grid, spin, cam, nu0)
        vcol = valid[:, None]
        bad = cbad | ~(torch.isfinite(j) & torch.isfinite(alpha))
        j = torch.where(bad, 0.0, j)
        alpha = torch.where(bad, 0.0, alpha)
        acc["bad"] = acc["bad"] | (vcol & bad)

        delta_lambda = -torch.where(valid, h, 0.0)
        dl_cgs = delta_lambda[:, None] * x_unit \
            / (frequencies[None, :] * mom[:, None])
        pos_alpha = alpha > 0.0
        ss = j / torch.where(pos_alpha, alpha, 1.0)
        delta_tau = alpha * dl_cgs
        atten = torch.exp(-acc["tau"])
        thin = delta_tau <= DELTA_TAU_MAX
        contrib = torch.where(pos_alpha,
                              torch.where(thin, ss * -torch.expm1(-delta_tau),
                                          ss),
                              j * dl_cgs)
        acc["intensity"] = acc["intensity"] + torch.where(
            vcol, contrib * atten, 0.0)
        dtau_eff = torch.where(pos_alpha,
                               torch.where(thin, delta_tau, math.inf), 0.0)
        acc["tau"] = acc["tau"] + torch.where(vcol, dtau_eff, 0.0)

    flag, n_samp = geo.trace_reference(positions, directions, params,
                                       integrator, transfer)
    poison = acc["bad"] | (flag & sp.sampler.fallback_nan)[:, None]
    i_nu = torch.where(poison, math.nan,
                       acc["intensity"] * image_scale(frequencies,
                                                      log_j_scale))
    return i_nu, flag, n_samp
