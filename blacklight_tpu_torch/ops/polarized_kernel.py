"""Fused polarized simulation-model kernel: geodesics + GRMHD grid
sampling + thermal polarized synchrotron coefficients + full-Stokes
transfer.

Port of ``blacklight_tpu/ops/pallas_polarized.py`` (``_make_kernel``
:286, launched by ``render_polarized`` :727; K3.1) for a single-block SKS
grid and thermal ti_te_beta electrons, with dp, rk4 and rk2 in float32
and float64. Its values follow the JAX package's exact (XLA) path,
``transfer/polarized.integrate_polarized`` with
``pipeline_simulation.make_simulation_coeff_fns(polarized=True)``, in each
dtype's forms; like the TPU kernel it leaves the camera-frame Stokes
extraction (``transfer/polarized.camera_stokes``) to the caller, and
marks the samples the reference would NaN, zeroing their coefficients.

``render_polarized`` dispatches on the device of the rays it is given: on
a CUDA device it launches the hand-written kernel
(``csrc/polarized_kernel.cuh``) or raises; on the CPU it runs
``render_polarized_reference``. There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from blacklight_tpu_torch.constants import Physics
from blacklight_tpu_torch.grid.athena import SimulationGrid
from blacklight_tpu_torch.grid.sampling import sample_grid
from blacklight_tpu_torch.models import synchrotron
from blacklight_tpu_torch.models.cuts import geometric_keep
from blacklight_tpu_torch.ops import _build
from blacklight_tpu_torch.ops import geodesic as geo
from blacklight_tpu_torch.ops import simulation_kernel as sk
from blacklight_tpu_torch.ops.formula_kernel import (
    INTEGRATORS,
    _DTYPE_CODES,
    _check_rays,
)
from blacklight_tpu_torch.transfer.polarized import (
    camera_stokes,
    integrate_polarized,
)

# Frequencies one launch takes (csrc/polarized_kernel.cuh): one frequency
# keeps its 16 coherency components in registers, more hold them in a
# local array. render_polarized launches once per this many frequencies.
MAX_FREQUENCIES = 4

# Steps per window of the kernel's two sweeps (at most
# csrc/polarized_kernel.cuh POL_MAX_WINDOW): sweep A keeps the state
# entering each window, sweep B replays a window into a per-thread array
# and takes its samples far end first. Measured on an H100 at 1024^2
# (2000 steps of rk4; PERF.md): each doubling from 32 to 512 took 8-10 %
# off the kernel, with bit-identical images; the cost is the per-thread
# sample array (15 KB of stack in float32, 30 KB in float64).
WINDOW = 512

# Device memory the window-entry table of one launch may take; a larger
# bundle is traced in several launches of fewer rays.
CARRY_BYTES_MAX = 8 << 30

# Kernel launches so far; render_polarized adds one per launch of the CUDA
# kernel and nowhere else.
LAUNCHES = 0

# Index order of the kernel's float64 parameter vector: the simulation
# kernel's (simulation_kernel.PARAM_NAMES), then the enum in
# csrc/polarized_params.cuh with its "P_" prefix dropped.
PARAM_NAMES = sk.PARAM_NAMES + ("ROTATION_SPLIT", "FALLBACK_RHO",
                                "FALLBACK_PGAS", "E_SQUARED", "ME_C")


def kernel_params(params: geo.GeodesicParams, sp: sk.SimKernelParams,
                  nu0: float, mass_msun: float, camera_x,
                  rotation_split: bool) -> list:
    """The kernel's parameter vector in PARAM_NAMES order."""
    values = dict(zip(sk.PARAM_NAMES, sk.kernel_params(
        params, sp, nu0, mass_msun, camera_x)))
    values.update({
        "ROTATION_SPLIT": rotation_split,
        "FALLBACK_RHO": sp.sampler.fallback_rho,
        "FALLBACK_PGAS": sp.sampler.fallback_pgas,
        "E_SQUARED": Physics.e ** 2, "ME_C": Physics.m_e * Physics.c})
    return geo.pack_params(PARAM_NAMES, values)


def carry_bytes_per_ray(dtype, max_steps: int, window: int) -> int:
    """Bytes of window-entry state one ray takes: per window, nine values
    in the working type (y, h, r_mid_prev) and two int32 (sample count;
    retry count and the alive/trunc/flag/prev_fail bits)."""
    item = torch.finfo(dtype).bits // 8
    return n_windows(max_steps, window) * (9 * item + 2 * 4)


def n_windows(max_steps: int, window: int) -> int:
    return -(-max_steps // window)


def render_polarized(positions, directions, momentum_factors, frequencies,
                     params: geo.GeodesicParams, sp: sk.SimKernelParams,
                     grid: SimulationGrid, mass_msun: float, camera_x,
                     log_j_scale: float, integrator: str = "rk4",
                     rotation_split: bool = False):
    """Fused polarized render of a ray bundle through a GRMHD snapshot.

    Arguments as ``simulation_kernel.render_simulation`` takes them, plus
    ``rotation_split`` (image_rotation_split). ``log_j_scale`` is not
    used here: ``camera_stokes`` applies the scale.

    Returns (nn_re (B, F, 10), nn_im (B, F, 6), flags (B,) bool,
    n_samples (B,) int32, bad (B, F) bool): the final coherency
    components in ``transfer/polarized`` _SYM/_ANT order, on the rays'
    device and in their dtype. ``bad`` marks the pixels that met a sample
    the reference would NaN. A CUDA device runs the CUDA kernel; the CPU
    runs ``render_polarized_reference``.
    """
    _check_rays(positions, directions, momentum_factors)
    sk._check_frequencies(frequencies, positions)
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator must be one of {INTEGRATORS}")
    sk.check_grid(grid)
    if grid.prim.device != positions.device:
        raise TypeError("the grid and the rays must share one device")
    device = positions.device
    args = (positions, directions, momentum_factors, frequencies, params, sp,
            grid, mass_msun, camera_x, log_j_scale, integrator,
            rotation_split)
    if device.type == "cuda":
        return _render_cuda(*args)
    if device.type == "cpu":
        return render_polarized_reference(*args)
    raise ValueError(f"no polarized kernel for device {device}")


def _render_cuda(positions, directions, momentum_factors, frequencies,
                 params, sp, grid, mass_msun, camera_x, log_j_scale,
                 integrator, rotation_split, window: int = WINDOW):
    """One launch per MAX_FREQUENCIES frequencies and per chunk of rays
    whose window-entry table fits CARRY_BYTES_MAX; every launch over the
    same rays traces them alike, so the flags and sample counts of the
    first stand."""
    global LAUNCHES
    del log_j_scale
    lib = _library()
    if not 1 <= window <= lib.blacklight_polarized_max_window():
        raise ValueError(f"window must be in [1, "
                         f"{lib.blacklight_polarized_max_window()}]")
    device, dtype = positions.device, positions.dtype
    b, nf = positions.shape[0], frequencies.shape[0]
    prm = torch.tensor(kernel_params(params, sp, float(frequencies[0]),
                                     mass_msun, camera_x, rotation_split),
                       dtype=torch.float64, device=device)
    table, coords = sk.kernel_tables(grid, dtype)
    n_k, n_j, n_i = table.shape[:3]
    nn = torch.empty((b, nf, 16), dtype=dtype, device=device)
    flags = torch.empty(b, dtype=torch.int32, device=device)
    n_samples = torch.empty(b, dtype=torch.int32, device=device)
    bad = torch.zeros((b, nf), dtype=torch.bool, device=device)
    if not b:
        return nn[..., :10], nn[..., 10:], flags.bool(), n_samples, bad
    per_ray = carry_bytes_per_ray(dtype, params.ray_max_steps, window)
    chunk = max(1, min(b, CARRY_BYTES_MAX // per_ray))
    carries = torch.empty(chunk * per_ray, dtype=torch.uint8, device=device)
    item = positions.element_size()
    for f0 in range(0, nf, MAX_FREQUENCIES):
        f1 = min(f0 + MAX_FREQUENCIES, nf)
        freqs = frequencies[f0:f1].contiguous()
        out = torch.empty((b, f1 - f0, 16), dtype=dtype, device=device)
        bits = torch.empty(b, dtype=torch.int32, device=device)
        for r0 in range(0, b, chunk):
            n = min(chunk, b - r0)
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                rc = lib.blacklight_polarized_launch(
                    _DTYPE_CODES[dtype], INTEGRATORS.index(integrator),
                    positions.data_ptr() + 4 * r0 * item,
                    directions.data_ptr() + 4 * r0 * item,
                    momentum_factors.data_ptr() + r0 * item,
                    freqs.data_ptr(), f1 - f0, prm.data_ptr(),
                    table.data_ptr(), coords.data_ptr(), n_i, n_j, n_k,
                    out.data_ptr() + 16 * (f1 - f0) * r0 * item,
                    flags.data_ptr() + 4 * r0, n_samples.data_ptr() + 4 * r0,
                    bits.data_ptr() + 4 * r0, carries.data_ptr(), window,
                    n_windows(params.ray_max_steps, window), n, stream)
            if rc != 0:
                msg = lib.blacklight_cuda_error_string(rc).decode()
                raise RuntimeError(f"polarized kernel launch failed: {msg} "
                                   f"({rc})")
            LAUNCHES += 1
        nn[:, f0:f1] = out
        shifts = torch.arange(f1 - f0, dtype=torch.int32, device=device)
        bad[:, f0:f1] = ((bits[:, None] >> shifts) & 1).bool()
    return nn[..., :10], nn[..., 10:], flags.bool(), n_samples, bad


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with the C interface of csrc/polarized_kernel.cu
    declared: every pointer and the stream as c_void_p."""
    lib = _build.load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.blacklight_polarized_launch.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, i32, i32,
        ptr, ptr, ptr, ptr, ptr, i32, i32, ctypes.c_longlong, ptr]
    lib.blacklight_polarized_launch.restype = ctypes.c_int
    for name in ("param_count", "max_frequencies", "max_window"):
        fn = getattr(lib, f"blacklight_polarized_{name}")
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.blacklight_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blacklight_cuda_error_string.restype = ctypes.c_char_p
    if lib.blacklight_polarized_param_count() != len(PARAM_NAMES):
        raise RuntimeError("csrc/polarized_params.cuh and PARAM_NAMES "
                           "disagree")
    if lib.blacklight_polarized_max_frequencies() != MAX_FREQUENCIES:
        raise RuntimeError("csrc/polarized_kernel.cuh and MAX_FREQUENCIES "
                           "disagree")
    return lib


def polarized_coefficients(pos, kcov, momentum_factors, frequencies,
                           sp: sk.SimKernelParams, grid: SimulationGrid,
                           spin, camera_x, nu0: float):
    """The polarized coeff_fn of ``transfer/polarized.integrate_polarized``
    at CKS positions ``pos`` with covariant momenta ``kcov`` (4-tuples of
    (B,) components): make_simulation_coeff_fns(polarized=True) for the
    slice. The sampled primitives are zeroed at geometrically cut samples
    before the fluid state (the reference's sampler leaves zeros there,
    which the tetrad consumes); the coefficients are zero where a cut
    holds or the field vanishes, and zero with ``bad`` set where the
    reference would NaN (an uncut off-grid sample under fallback_nan, or
    a coefficient that is not finite)."""
    posb = torch.stack(pos, dim=-1)
    samples = sample_grid(grid, posb, spin, sp.sampler)
    keep_geo = geometric_keep(posb, spin, camera_x, sp.geometric)
    samples = {k: v if k in ("off_grid", "nan_mask")
               else torch.where(keep_geo, v, 0.0)
               for k, v in samples.items()}
    state = synchrotron.fluid_state(posb, samples, spin, sp.plasma,
                                    sp.rho_unit)
    keep_val = synchrotron.value_cuts(state, sp.cuts)
    b_zero = ((samples["bb1"] == 0.0) & (samples["bb2"] == 0.0)
              & (samples["bb3"] == 0.0))
    sin_b, cos_b, sin2_b, u_dot_k = synchrotron.pitch_angle(kcov, state)
    nu_cgs = -u_dot_k[:, None] * frequencies[None, :] \
        * momentum_factors[:, None]
    coeffs = synchrotron.thermal_coefficients(
        nu_cgs, nu0, state, sin_b, sp.plasma, cos_theta_b=cos_b,
        sin2_theta_b=sin2_b, polarized=True)
    keep = (keep_geo & keep_val & ~b_zero)[:, None]
    coeffs = {k: torch.where(keep, v, 0.0) for k, v in coeffs.items()}
    bad = (samples["nan_mask"] & keep_geo)[:, None].expand(nu_cgs.shape)
    for v in coeffs.values():
        bad = bad | ~torch.isfinite(v)
    out = {k: torch.where(bad, 0.0, v) for k, v in coeffs.items()}
    out.update(bad=bad, ucon=state["ucon"], bcon=state["bcon"],
               b_zero=b_zero)
    return out


def render_polarized_reference(positions, directions, momentum_factors,
                               frequencies, params: geo.GeodesicParams,
                               sp: sk.SimKernelParams, grid: SimulationGrid,
                               mass_msun: float, camera_x,
                               log_j_scale: float = 0.0,
                               integrator: str = "rk4",
                               rotation_split: bool = False):
    """The kernel's function in plain torch ops:
    ``transfer/polarized.integrate_polarized`` (the windowed sweep and
    its reverse replay) with ``polarized_coefficients`` at every sample.
    Returns what ``render_polarized`` returns."""
    del log_j_scale
    _check_rays(positions, directions, momentum_factors)
    sk._check_frequencies(frequencies, positions)
    nu0 = float(frequencies[0])
    cam = [float(v) for v in camera_x]

    def coeff_fn(pos, kcov):
        return polarized_coefficients(pos, kcov, momentum_factors,
                                      frequencies, sp, grid, params.bh_a,
                                      cam, nu0)

    return integrate_polarized(
        positions, directions, momentum_factors, frequencies, params=params,
        integrator=integrator, coeff_fn=coeff_fn, mass_msun=mass_msun,
        rotation_split=rotation_split)


def poisoned_stokes(nn_re, nn_im, flags, bad, positions, directions,
                    frequencies, params: geo.GeodesicParams, geom,
                    log_j_scale: float, fallback_nan: bool) -> dict:
    """Camera-frame I, Q, U, V (B, F) from ``render_polarized``'s output,
    NaN where ``(flags & fallback_nan) | bad`` (pipeline_simulation.py
    :492-510)."""
    stokes = camera_stokes(nn_re, nn_im, positions, directions, params.bh_a,
                           params.bh_m, params.ray_flat, frequencies,
                           geom.u_con, geom.u_cov, geom.vert_con_c,
                           log_j_scale)
    poison = (flags & fallback_nan)[:, None] | bad
    return {k: torch.where(poison, math.nan, v)
            for k, v in zip(("I_nu", "Q_nu", "U_nu", "V_nu"), stokes)}
