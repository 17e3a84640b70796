"""End-to-end orchestration: config -> camera -> fused kernel -> output.

Port of the formula-model path of ``blacklight_tpu/pipeline.py``
(:32-122, :221-334), with the same timing report. Geodesics, formula
coefficients and transfer run as one fused kernel
(``ops/formula_kernel.render_formula``): the CUDA kernel for a CUDA
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

from blacklight_tpu.constants import (
    ModelType,
    OutputFormat,
    Physics,
    RayIntegrator,
    RayTerminate,
)
from blacklight_tpu.output import (
    assemble_npz_arrays,
    format_filename,
    validate_output_options,
    write_output,
)
from blacklight_tpu.utils.config import warn_ignored_options
from blacklight_tpu.utils.errors import BlacklightError, blacklight_warning
from blacklight_tpu_torch.camera import CameraRays, make_camera
from blacklight_tpu_torch.models import formula as formula_model
from blacklight_tpu_torch.ops import geodesic
from blacklight_tpu_torch.ops.formula_kernel import render_formula

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

    if cfg.require("model_type") != ModelType.formula:
        refuse("the simulation model", "B")
    if not cfg.require("image_light"):
        refuse("image_light = false", "A.5")
    for key in _AUX_IMAGES:
        if getattr(cfg, key):
            refuse(f"{key}", "A.5")
    if cfg.require("image_num_frequencies") > 1:
        refuse("image_num_frequencies > 1", "K1.3")
    if (cfg.adaptive_max_level or 0) > 0:
        refuse("adaptive_max_level > 0", "A.9")
    for key in ("checkpoint_geodesic_save", "checkpoint_geodesic_load",
                "checkpoint_sample_save", "checkpoint_sample_load"):
        if getattr(cfg, key):
            refuse(f"{key}", "A.8")
    if cfg.image_polarization:
        refuse("image_polarization", "C.1")
    if (cfg.render_num_images or 0) > 0:
        refuse("rendering (render_num_images > 0)", "D.1")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise BlacklightError("device cuda requested but "
                              "torch.cuda.is_available() is false")
    if device.type not in ("cuda", "cpu"):
        raise BlacklightError(f"unsupported device {device}")
    return device


def make_formula_renderer(cfg, *, device):
    """Build the formula-model renderer on ``device``.

    Returns (render_fn, geom, rays, frequencies, mass_msun), where
    render_fn(positions, directions, momentum_factors) renders a pixel
    bundle to a dict of tensors: "I_nu" (B, 1), "_flags" (B,) bool and
    "_n_samples" (B,).
    """
    check_slice(cfg)
    device = _device(device)
    dtype = compute_dtype(cfg)
    bh_m, bh_a, mass_msun = bh_mass_spin(cfg)
    geom, rays, frequencies = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                          device=device, dtype=dtype)
    params = geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = formula_model.formula_params_from_config(cfg)
    nu = float(frequencies[0])
    camera_x = geom.cam_x.tolist()
    log_j_scale = formula_model.formula_log_j_scale(fparams)
    fallback_nan = cfg.require("fallback_nan")

    def render_fn(positions, directions, momentum_factors):
        i_nu, flags, n_samples = render_formula(
            positions, directions, momentum_factors, nu, params, fparams,
            mass_msun, camera_x, log_j_scale, fallback_nan=fallback_nan,
            integrator=params.integrator.value)
        return {"I_nu": i_nu, "_flags": flags, "_n_samples": n_samples}

    render_fn.geodesic_params = params
    return render_fn, geom, rays, frequencies, mass_msun


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run(cfg, snapshot: Optional[int] = None, quiet: bool = False, *,
        device="cuda") -> dict:
    """Full run for one snapshot on ``device`` ("cuda" or "cpu").

    Returns the dict of named output arrays written to disk.
    """
    validate_output_options(cfg)
    warn_ignored_options(cfg)

    t0 = time.time()
    render_fn, geom, rays, frequencies, mass_msun = make_formula_renderer(
        cfg, device=device)
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
    path = format_filename(cfg.require("output_file"), snapshot)
    packed = None
    if cfg.require("output_format") != OutputFormat.npz:
        res = cfg.require("camera_resolution")
        packed = image["I_nu"].reshape(1, res, res)
    write_output(cfg, path, arrays, image_packed=packed)

    if not quiet:
        # Reference timing report (blacklight.cpp:259-269); geodesic,
        # sampling and image integration are one fused kernel
        print("Calculation completed.")
        print(f"Elapsed time:                        {time.time() - t0:.6g} s")
        print(f"  Time reading simulation data:      {0.0:.6g} s")
        print(f"  Time integrating rays+sample+image: {t_image:.6g} s (fused)")
    return arrays
