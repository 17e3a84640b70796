"""End-to-end orchestration: config -> camera -> fused kernel -> output.

Port of ``blacklight_tpu/pipeline.py`` (:32-122, :221-334), with the same
timing report, for the formula model and (through
``pipeline_simulation``) the simulation model. Geodesics, coefficients
and transfer run as one fused kernel per model
(``ops/formula_kernel.render_formula``,
``ops/simulation_kernel.render_simulation``): the CUDA kernel for a CUDA
device, its plain PyTorch version for the CPU.

The configurations this package covers so far are decided from the
config before any work starts; every other one raises BlacklightError
naming the ROADMAP item that will bring it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from blacklight_tpu_torch.constants import (
    Coordinates,
    ModelType,
    OutputFormat,
    Physics,
    PlasmaModel,
    RayIntegrator,
    RayTerminate,
    SimulationFormat,
)
from blacklight_tpu_torch.output import (
    assemble_npz_arrays,
    format_filename,
    validate_output_options,
    write_output,
)
from blacklight_tpu_torch.utils.config import warn_ignored_options
from blacklight_tpu_torch.utils.errors import BlacklightError, blacklight_warning
from blacklight_tpu_torch.camera import CameraRays, make_camera
from blacklight_tpu_torch.models import formula as formula_model
from blacklight_tpu_torch.ops import geodesic
from blacklight_tpu_torch.ops.formula_kernel import (
    frequency_list,
    render_formula,
)
from blacklight_tpu_torch.ops.simulation_kernel import spatial_order

# Rays per tile of the spatial_order that float64 formula bundles are
# launched in (formula_launch_order).
FORMULA_ORDER_BLOCK = 256

_AUX_IMAGES = ("image_time", "image_length", "image_lambda", "image_emission",
               "image_tau", "image_lambda_ave", "image_emission_ave",
               "image_tau_int", "image_crossings")


def compute_dtype(cfg) -> torch.dtype:
    precision = cfg.precision or "float64"
    if precision == "float32":
        return torch.float32
    if precision == "float64":
        return torch.float64
    raise BlacklightError(f"Unknown precision ({precision}) in input file.")


def geodesic_params_from_config(cfg, bh_m: float,
                                bh_a: float) -> geodesic.GeodesicParams:
    integrator = cfg.require("ray_integrator")
    kwargs = {}
    if integrator == RayIntegrator.dp:
        kwargs = dict(ray_tol_abs=cfg.require("ray_tol_abs"),
                      ray_tol_rel=cfg.require("ray_tol_rel"),
                      ray_max_retries=cfg.require("ray_max_retries"))
    ray_terminate = cfg.require("ray_terminate")
    ray_factor = cfg.require("ray_factor") \
        if ray_terminate != RayTerminate.photon else 0.0
    return geodesic.GeodesicParams(
        integrator=integrator, bh_m=bh_m, bh_a=bh_a,
        ray_flat=cfg.require("ray_flat"),
        ray_step=cfg.require("ray_step"),
        ray_max_steps=cfg.require("ray_max_steps"),
        r_terminate=geodesic.terminate_radius(ray_terminate, ray_factor,
                                              bh_m, bh_a),
        camera_r=cfg.require("camera_r"),
        r_horizon=geodesic.horizon_radius(bh_m, bh_a),
        **kwargs)


def bh_mass_spin(cfg):
    """(bh_m, bh_a, mass_msun) per model type (geodesic_integrator.cpp:
    107-116, radiation_integrator.cpp:420-431)."""
    if cfg.require("model_type") == ModelType.simulation:
        return 1.0, cfg.require("simulation_a"), cfg.require("simulation_m_msun")
    mass_msun = cfg.require("formula_mass") * Physics.c ** 2 / Physics.gg_msun
    return 1.0, cfg.require("formula_spin"), mass_msun


def check_slice(cfg) -> None:
    """Raise BlacklightError for a configuration this package does not
    cover yet, naming the ROADMAP item that will bring it."""
    def refuse(what, item):
        raise BlacklightError(
            f"blacklight_tpu_torch does not support {what} yet "
            f"(ROADMAP {item}); use blacklight_tpu for this input.")

    simulation = cfg.require("model_type") == ModelType.simulation
    if not cfg.require("image_light"):
        refuse("image_light = false", "A.5")
    for key in _AUX_IMAGES:
        if getattr(cfg, key):
            refuse(f"{key}", "A.5")
    if (cfg.adaptive_max_level or 0) > 0:
        refuse("adaptive_max_level > 0", "A.9")
    for key in ("checkpoint_geodesic_save", "checkpoint_geodesic_load",
                "checkpoint_sample_save", "checkpoint_sample_load"):
        if getattr(cfg, key):
            refuse(f"{key}", "A.8")
    if (cfg.render_num_images or 0) > 0:
        refuse("rendering (render_num_images > 0)", "D.1")
    if simulation:
        _check_simulation_slice(cfg, refuse)


def _check_simulation_slice(cfg, refuse) -> None:
    fmt = cfg.simulation_format
    if fmt != SimulationFormat.athena:
        refuse(f"simulation_format = {fmt.value if fmt else None}", "B.4")
    if cfg.simulation_coord != Coordinates.sks:
        coord = cfg.simulation_coord
        refuse(f"simulation_coord = {coord.value if coord else None}",
               "B.4")
    if not cfg.require("simulation_interp"):
        refuse("simulation_interp = false", "B.1b")
    if cfg.simulation_block_interp:
        refuse("simulation_block_interp = true (AMR)", "B.5")
    if cfg.require("simulation_multiple") and cfg.slow_light_on:
        refuse("slow light", "B.6")
    if cfg.require("plasma_model") != PlasmaModel.ti_te_beta:
        refuse(f"plasma_model = {cfg.plasma_model.value}", "B.2")
    for key in ("plasma_power_frac", "plasma_kappa_frac"):
        if cfg.require(key) != 0.0:
            refuse(f"{key} != 0", "B.2")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, a card with its index ("cuda" is the
    current card, as tensors report it); raises BlacklightError for one
    this package cannot run on here."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise BlacklightError("device cuda requested but "
                              "torch.cuda.is_available() is false")
    if device.type not in ("cuda", "cpu"):
        raise BlacklightError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_formula_renderer(cfg, *, device):
    """Build the formula-model renderer on ``device``.

    Returns (render_fn, geom, rays, frequencies, mass_msun), where
    render_fn(positions, directions, momentum_factors) renders a pixel
    bundle to a dict of tensors: "I_nu" (B, F), "_flags" (B,) bool and
    "_n_samples" (B,).
    """
    check_slice(cfg)
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    bh_m, bh_a, mass_msun = bh_mass_spin(cfg)
    geom, rays, frequencies = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                          device=device, dtype=dtype)
    params = geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = formula_model.formula_params_from_config(cfg)
    nus = frequency_list(frequencies)
    camera_x = geom.cam_x.tolist()
    log_j_scale = formula_model.formula_log_j_scale(fparams)
    fallback_nan = cfg.require("fallback_nan")

    def render_fn(positions, directions, momentum_factors):
        order = formula_launch_order(positions)
        rays = (positions, directions, momentum_factors)
        if order is not None:
            rays = tuple(t[order] for t in rays)
        i_nu, flags, n_samples = render_formula(
            *rays, nus, params, fparams, mass_msun, camera_x, log_j_scale,
            fallback_nan=fallback_nan, integrator=params.integrator.value)
        out = {"I_nu": i_nu, "_flags": flags, "_n_samples": n_samples}
        if order is None:
            return out
        for key, value in out.items():
            out[key] = torch.empty_like(value)
            out[key][order] = value
        return out

    render_fn.geodesic_params = params
    return render_fn, geom, rays, frequencies, mass_msun


def formula_launch_order(positions):
    """The order a formula bundle is launched in: None (as given) for
    float32, spatial_order's camera-plane tiles for float64, where the
    kernel ran faster in them (PERF.md §6). A permutation (B,) int64
    on the rays' device; the renderer returns its outputs in the caller's
    order."""
    if positions.dtype != torch.float64 or positions.shape[0] < 2:
        return None
    return spatial_order(positions, block=FORMULA_ORDER_BLOCK)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run(cfg, snapshot: Optional[int] = None, quiet: bool = False, *,
        device="cuda", grid=None) -> dict:
    """Full run for one snapshot on ``device`` ("cuda" or "cpu").

    grid: for the simulation model, a snapshot already on ``device``
    (``grid.athena.SimulationGrid``) rendered in place of
    ``simulation_file``.

    Returns the dict of named output arrays written to disk.
    """
    validate_output_options(cfg)
    warn_ignored_options(cfg)
    check_slice(cfg)
    simulation = cfg.require("model_type") == ModelType.simulation

    t0 = time.time()
    if simulation:
        from blacklight_tpu_torch.pipeline_simulation import (
            make_simulation_renderer)
        render_fn, geom, rays, frequencies, mass_msun = \
            make_simulation_renderer(cfg, snapshot, device=device, grid=grid)
        t_read = time.time() - t0
    else:
        render_fn, geom, rays, frequencies, mass_msun = \
            make_formula_renderer(cfg, device=device)
        t_read = 0.0
    t1 = time.time()
    image = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    image = {k: _to_numpy(v) for k, v in image.items()}  # waits for the device
    t_image = time.time() - t1

    n_bad = int(np.sum(image["_flags"]))
    if n_bad > 0:
        blacklight_warning(
            f"{n_bad} out of {len(image['_flags'])} geodesics terminate "
            "unexpectedly.")

    host_rays = CameraRays(positions=_to_numpy(rays.positions),
                           directions=_to_numpy(rays.directions),
                           momentum_factors=_to_numpy(rays.momentum_factors))
    arrays = assemble_npz_arrays(cfg, image, mass_msun=mass_msun,
                                 frequencies=_to_numpy(frequencies),
                                 camera_rays=host_rays)
    # numbered outputs follow the snapshot (output_writer.cpp:248-254)
    file_number = snapshot
    if snapshot is not None and simulation \
            and cfg.require("simulation_multiple"):
        file_number = snapshot + cfg.require("simulation_start")
    path = format_filename(cfg.require("output_file"), file_number)
    packed = None
    if cfg.require("output_format") != OutputFormat.npz:
        # the packed (quantities, res, res) block: I, or I, Q, U, V
        res = cfg.require("camera_resolution")
        packed = image["I_nu"].reshape(1, res, res)
        if "Q_nu" in image:
            packed = np.stack([image[k].reshape(res, res)
                               for k in ("I_nu", "Q_nu", "U_nu", "V_nu")])
    write_output(cfg, path, arrays, image_packed=packed)

    if not quiet:
        # Reference timing report (blacklight.cpp:259-269); geodesic,
        # sampling and image integration are one fused kernel
        print("Calculation completed.")
        print(f"Elapsed time:                        {time.time() - t0:.6g} s")
        print(f"  Time reading simulation data:      {t_read:.6g} s")
        print(f"  Time integrating rays+sample+image: {t_image:.6g} s (fused)")
    return arrays
