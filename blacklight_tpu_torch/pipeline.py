"""End-to-end orchestration: config -> camera -> fused kernel -> output.

Port of ``blacklight_tpu/pipeline.py`` (:32-122, :141-334), with the same
timing report, for the formula model and (through
``pipeline_simulation``) the simulation model. Geodesics, coefficients
and transfer of the light image run as one fused kernel per model
(``ops/formula_kernel.render_formula``,
``ops/simulation_kernel.render_simulation``): the CUDA kernel for a CUDA
device, its plain PyTorch version for the CPU. A configuration with an
auxiliary image plane or image_light = false takes the scan route
instead: ``transfer/unpolarized.integrate_unpolarized`` in torch ops on
the rays' device, which the JAX package's formula ``run`` always takes;
so does a simulation with false-color renderings
(``transfer/rendering``), which the formula model ignores with a warning,
as the JAX package does.
With adaptive_max_level > 0, ``adaptive_loop`` renders each refinement
level's child blocks through the root image's route.

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
    ModelType,
    OutputFormat,
    Physics,
    RayIntegrator,
    RayTerminate,
)
from blacklight_tpu_torch.output import (
    assemble_npz_arrays,
    format_filename,
    shape_adaptive_level,
    validate_output_options,
    write_output,
)
from blacklight_tpu_torch.utils.config import warn_ignored_options
from blacklight_tpu_torch.utils.errors import BlacklightError, blacklight_warning
from blacklight_tpu_torch import adaptive
from blacklight_tpu_torch.camera import (
    CameraRays,
    block_pixel_grid,
    init_pixels,
    make_camera,
)
from blacklight_tpu_torch.models import formula as formula_model
from blacklight_tpu_torch.ops import geodesic
from blacklight_tpu_torch.ops.formula_kernel import (
    frequency_list,
    render_formula,
)
from blacklight_tpu_torch.ops.simulation_kernel import spatial_order
from blacklight_tpu_torch.transfer import unpolarized as tu

# Rays per tile of the spatial_order that float64 formula bundles are
# launched in (formula_launch_order).
FORMULA_ORDER_BLOCK = 256


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
    for key in ("checkpoint_geodesic_save", "checkpoint_geodesic_load",
                "checkpoint_sample_save", "checkpoint_sample_load"):
        if getattr(cfg, key):
            refuse(f"{key}", "A.8")
    if simulation:
        _check_simulation_slice(cfg, refuse)


def _check_simulation_slice(cfg, refuse) -> None:
    # the port reads every format the JAX package reads: Athena++ (SKS),
    # AthenaK (CKS), iharm3d (MKS as SKS, or FMKS) and harm3d (MKS as
    # SKS); the loaders and the renderer check the coordinates as the JAX
    # package's do
    if cfg.require("simulation_multiple") and cfg.slow_light_on:
        refuse("slow light", "B.6")


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
    bundle to a dict of tensors: "I_nu" (B, F) (none with image_light =
    false), the auxiliary planes the config asks for, "_flags" (B,) bool
    and "_n_samples" (B,). ``render_fn.route`` is "kernel" (the light
    image alone: ``render_formula``) or "scan" (any auxiliary plane or
    image_light = false: ``transfer/unpolarized.integrate_unpolarized``
    with the batched ``formula_coefficients``, as the JAX package's
    formula renderer, blacklight_tpu/pipeline.py:76-122).
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
    opts = tu.ImageOptions.from_config(cfg)

    def coeff_fn(pos, kcov, momentum_factors):
        j, alpha, _, bad = formula_model.formula_coefficients(
            pos, torch.stack(kcov, dim=-1), momentum_factors, frequencies,
            fparams, camera_x)
        return j, alpha, bad

    def render_scan(positions, directions, momentum_factors):
        return tu.integrate_unpolarized(
            positions, directions, momentum_factors, frequencies,
            params=params, integrator=params.integrator.value,
            coeff_fn=coeff_fn, opts=opts, mass_msun=mass_msun,
            camera_x=camera_x, log_j_scale=log_j_scale)

    def render_kernel(positions, directions, momentum_factors):
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

    scan = opts.aux or not opts.light
    render_fn = render_scan if scan else render_kernel
    render_fn.route = "scan" if scan else "kernel"
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


def _host_rays(rays: CameraRays) -> CameraRays:
    return CameraRays(positions=_to_numpy(rays.positions),
                      directions=_to_numpy(rays.directions),
                      momentum_factors=_to_numpy(rays.momentum_factors))


def _rendering(image: dict):
    """The false-color renderings of a host image in the output's layout,
    (n_images, 3, B) from (B, n_images, 3); None without them."""
    if "rendering" not in image:
        return None
    return np.transpose(image["rendering"], (1, 2, 0))


def adaptive_loop(cfg, render_fn, geom, root_image) -> list:
    """Adaptive refinement (``blacklight_tpu/pipeline.py:141-218``,
    reference blacklight.cpp:198-236): at each level evaluate the blocks
    on the host, spawn 4 children at doubled resolution per flagged block
    and render only the new pixels with ``render_fn``, the root image's
    renderer (the same kernel or scan route). The child rays are made on
    the camera's device; each level's image comes back to the host once,
    for the criteria and the output.

    root_image: the root render as a dict of numpy arrays. Returns the
    per-level dicts that ``output.assemble_npz_arrays`` takes.
    """
    p_ad = adaptive.AdaptiveParams.from_config(cfg)
    if p_ad.max_level == 0:
        return []
    res = cfg.require("camera_resolution")
    width = cfg.require("camera_width")
    freq_idx = p_ad.frequency_num - 1
    bs = p_ad.block_size
    bh_m, bh_a, _ = bh_mass_spin(cfg)
    camera_out = cfg.require("output_camera")

    def criteria_intensity(image):
        # I_nu at the adaptive frequency; Stokes I when polarized
        # (radiation_adaptive.cpp:72-77)
        return image["I_nu"][:, freq_idx]

    locs = adaptive.root_block_locs(res, bs)
    blocks = adaptive.extract_root_blocks(criteria_intensity(root_image),
                                          res, bs)
    levels = []
    level = 0
    while level < p_ad.max_level:
        flags = adaptive.check_refinement(blocks, locs, level, res, width,
                                          p_ad)
        if not flags.any():
            break
        locs = adaptive.child_block_locs(locs, flags)
        level += 1
        u_ind, v_ind = block_pixel_grid(
            locs[:, 1], locs[:, 0], bs, res << level,
            device=geom.cam_x.device, dtype=geom.cam_x.dtype)
        child_rays = init_pixels(
            geom, u_ind, v_ind, camera_type=cfg.require("camera_type"),
            bh_m=bh_m, bh_a=bh_a, camera_width=width,
            camera_r=cfg.require("camera_r"),
            image_normalization=cfg.require("image_normalization"),
            ray_flat=cfg.require("ray_flat"))
        # The exact bundle: the JAX loop pads it to a power of two of
        # blocks only so that XLA reuses its compiled executables (the
        # padding repeats ray 0 and is sliced off); a launch takes any
        # number of rays and gives the same pixels.
        image = render_fn(child_rays.positions, child_rays.directions,
                          child_rays.momentum_factors)
        image = {k: _to_numpy(v) for k, v in image.items()}
        n_blocks = locs.shape[0]
        lvl = {"num_blocks": n_blocks, "block_locs": locs}
        lvl.update(shape_adaptive_level(
            cfg, image, n_blocks, bs,
            camera_rays=_host_rays(child_rays) if camera_out else None,
            rendering=_rendering(image)))
        levels.append(lvl)
        blocks = adaptive.blocks_from_bundle(criteria_intensity(image),
                                             n_blocks, bs)
    return levels


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
    adaptive.AdaptiveParams.from_config(cfg)  # its errors before any work
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
    adaptive_levels = adaptive_loop(cfg, render_fn, geom, image)
    t_image = time.time() - t1

    n_bad = int(np.sum(image["_flags"]))
    if n_bad > 0:
        blacklight_warning(
            f"{n_bad} out of {len(image['_flags'])} geodesics terminate "
            "unexpectedly.")

    arrays = assemble_npz_arrays(cfg, image, mass_msun=mass_msun,
                                 frequencies=_to_numpy(frequencies),
                                 camera_rays=_host_rays(rays),
                                 rendering=_rendering(image),
                                 adaptive_levels=adaptive_levels)
    # numbered outputs follow the snapshot (output_writer.cpp:248-254)
    file_number = snapshot
    if snapshot is not None and simulation \
            and cfg.require("simulation_multiple"):
        file_number = snapshot + cfg.require("simulation_start")
    path = format_filename(cfg.require("output_file"), file_number)
    packed = None
    if cfg.require("output_format") != OutputFormat.npz:
        # the packed (quantities, res, res) block: I, or I, Q, U, V; none
        # without a light image (blacklight_tpu/pipeline.py:316-326)
        res = cfg.require("camera_resolution")
        if "I_nu" in image:
            packed = image["I_nu"].reshape(1, res, res)
        if "Q_nu" in image:
            packed = np.stack([image[k].reshape(res, res)
                               for k in ("I_nu", "Q_nu", "U_nu", "V_nu")])
    write_output(cfg, path, arrays, image_packed=packed)

    if not quiet:
        # Reference timing report (blacklight.cpp:259-269); geodesic,
        # sampling and image integration are one fused computation
        print("Calculation completed.")
        print(f"Elapsed time:                        {time.time() - t0:.6g} s")
        print(f"  Time reading simulation data:      {t_read:.6g} s")
        print(f"  Time integrating rays+sample+image: {t_image:.6g} s (fused)")
    return arrays
