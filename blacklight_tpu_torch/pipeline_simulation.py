"""Simulation-model pipeline: GRMHD snapshot -> fused ray trace -> image.

Port of ``blacklight_tpu/pipeline_simulation.py`` (:70-254, :257-707)
for the port's slice (``pipeline.check_slice``): one Athena++ snapshot
of one or many mesh blocks (with its neighbour table for exact
interblock sampling), one AthenaK snapshot in Cartesian Kerr-Schild
coordinates (the same, without a periodic axis), or one iharm3d (MKS or
FMKS) or harm3d snapshot, read once onto the device, and one of two
routes,
chosen from the config before anything launches, as the JAX package
chooses between its kernels and its XLA path
(blacklight_tpu/pipeline_simulation.py:348-370, :466-474):

- "kernel", the light image alone: one fused kernel that integrates the
  geodesics, samples the grid, evaluates the synchrotron coefficients
  (thermal electrons at the ti_te_beta or the code_kappa temperature,
  alone or mixed with power-law and kappa ones: the kernels' mixture
  instantiations take all but thermal ti_te_beta electrons alone) and
  accumulates the transfer,
  unpolarized
  (``ops/simulation_kernel.render_simulation``, or with KERNEL_PHASED its
  phased dispatch ``render_simulation_phased``) or, with
  image_polarization, full-Stokes (``ops/polarized_kernel.render_polarized``
  followed by the camera-frame Stokes extraction); each the CUDA kernel
  for a CUDA device, its plain PyTorch version for the CPU. Rays are
  launched in ``spatial_order``.
- "scan", any auxiliary image plane, image_light = false or a
  false-color rendering (render_num_images > 0): the transfer in torch
  ops on the rays' device (``transfer/unpolarized.integrate_unpolarized``,
  or with image_polarization ``transfer/polarized.integrate_polarized``),
  with ``make_simulation_coeff_fns``' coefficients and cell values; the
  renderings ride the unpolarized trace
  (``transfer/rendering.Renderer``), or with image_polarization a trace of
  their own (``transfer/rendering.integrate_rendering``), as the JAX
  package's XLA path renders them (blacklight_tpu/pipeline_simulation.py
  :596-606).

Nothing falls back from one route to another.
"""

from __future__ import annotations

from typing import Optional

import torch

from blacklight_tpu_torch.constants import (
    Coordinates,
    PlasmaModel,
    SimulationFormat,
)
from blacklight_tpu_torch.output import format_filename
from blacklight_tpu_torch.utils.errors import BlacklightError
from blacklight_tpu_torch.camera import make_camera
from blacklight_tpu_torch.grid.amr import with_amr_table
from blacklight_tpu_torch.grid.athena import SimulationGrid, load_athdf
from blacklight_tpu_torch.grid.athenak import load_athenak
from blacklight_tpu_torch.grid.harm3d import load_harm3d
from blacklight_tpu_torch.grid.iharm3d import load_iharm3d
from blacklight_tpu_torch.grid.sampling import sampling_mode
from blacklight_tpu_torch.models import synchrotron
from blacklight_tpu_torch.models.cuts import GeometricCuts
from blacklight_tpu_torch.ops import polarized_kernel, simulation_kernel
from blacklight_tpu_torch.transfer import polarized as tp
from blacklight_tpu_torch.transfer import rendering
from blacklight_tpu_torch.transfer import unpolarized as tu

# Phased dispatch of the unpolarized kernel
# (ops/simulation_kernel.render_simulation_phased), with the JAX package's
# names (blacklight_tpu/pipeline_simulation.py:52-67): the step budget is
# split into phases of KERNEL_PHASE_STEPS and finished rays leave the pool
# between phases. It is off, as in the JAX package: on an H100 the
# monolithic kernel in spatial_order beats it (PERF.md, chip_smoke.py phase
# 13). Phases are the port's PHASE_STEPS long (the JAX package's are 512).
# It takes rk4 and rk2 bundles of at least KERNEL_PHASE_CHUNK rays whose
# step budget is longer than a phase.
KERNEL_PHASED = False
KERNEL_PHASE_STEPS = simulation_kernel.PHASE_STEPS
KERNEL_PHASE_CHUNK = 65536
# Rays per tile of spatial_order, the order every kernel bundle is launched
# in (and of angular_order, the order of the survivors between phases).
# Chosen on an H100 (PERF.md, chip_smoke.py phase 13): at 1024^2 the
# simulation kernel's 128-ray blocks do useful work 96.5 % of block-time
# with 256 (83.8 % in camera order, 94.8 % with the JAX package's 1024;
# 4096 and 16384 tie with 256), and the kernel took 140.94 ms there
# against 143.84 ms at 1024 and 161.89 ms in camera order.
KERNEL_ORDER_BLOCK = 256


def use_phased(integrator: str, max_steps: int, n_rays: int) -> bool:
    """Whether an unpolarized bundle takes phased dispatch (the JAX
    package's condition, blacklight_tpu/pipeline_simulation.py:400-401,
    :416)."""
    return (KERNEL_PHASED and integrator in ("rk4", "rk2")
            and max_steps > KERNEL_PHASE_STEPS
            and n_rays >= KERNEL_PHASE_CHUNK)


def _unorder(value, order):
    """``value`` (rows in launch order) back in the caller's ray order."""
    out = torch.empty_like(value)
    out[order] = value
    return out


def plasma_params_from_config(cfg) -> synchrotron.PlasmaParams:
    model = cfg.require("plasma_model")
    power_frac = cfg.require("plasma_power_frac")
    kappa_frac = cfg.require("plasma_kappa_frac")
    thermal_frac = 1.0 - power_frac - kappa_frac
    if thermal_frac < 0.0 or thermal_frac > 1.0:
        raise BlacklightError("Invalid plasma distribution fractions.")
    ti_te = model == PlasmaModel.ti_te_beta
    use_p = cfg.require("plasma_use_p") if ti_te else True
    kwargs = {}
    if ti_te and not use_p:
        kwargs = dict(gamma=cfg.require("plasma_gamma"),
                      gamma_i=cfg.require("plasma_gamma_i"),
                      gamma_e=cfg.require("plasma_gamma_e"))
    if power_frac != 0.0:
        kwargs.update(power_p=cfg.require("plasma_p"),
                      gamma_min=cfg.require("plasma_gamma_min"),
                      gamma_max=cfg.require("plasma_gamma_max"))
    if kappa_frac != 0.0:
        kwargs.update(kappa=cfg.require("plasma_kappa"),
                      w=cfg.require("plasma_w"))
    return synchrotron.PlasmaParams(
        mu=cfg.require("plasma_mu"), ne_ni=cfg.require("plasma_ne_ni"),
        model=model, use_p=use_p,
        rat_low=cfg.require("plasma_rat_low") if ti_te else 1.0,
        rat_high=cfg.require("plasma_rat_high") if ti_te else 1.0,
        power_frac=power_frac, kappa_frac=kappa_frac, **kwargs)


def cut_params_from_config(cfg) -> synchrotron.CutParams:
    return synchrotron.CutParams(
        rho_min=cfg.require("cut_rho_min"), rho_max=cfg.require("cut_rho_max"),
        n_e_min=cfg.require("cut_n_e_min"), n_e_max=cfg.require("cut_n_e_max"),
        p_gas_min=cfg.require("cut_p_gas_min"),
        p_gas_max=cfg.require("cut_p_gas_max"),
        theta_e_min=cfg.require("cut_theta_e_min"),
        theta_e_max=cfg.require("cut_theta_e_max"),
        b_min=cfg.require("cut_b_min"), b_max=cfg.require("cut_b_max"),
        sigma_min=cfg.require("cut_sigma_min"),
        sigma_max=cfg.require("cut_sigma_max"),
        beta_inverse_min=cfg.require("cut_beta_inverse_min"),
        beta_inverse_max=cfg.require("cut_beta_inverse_max"))


def load_grid_file(cfg, path: str, *, device, dtype) -> SimulationGrid:
    """Load one snapshot file in the configured format
    (blacklight_tpu/pipeline_simulation.py:116-140): with plasma_model =
    code_kappa the Athena++ and AthenaK loaders read the kappa slot from
    the variable simulation_kappa_name (the iharm3d and harm3d loaders
    read the configuration themselves); an AthenaK file's parameters are
    held against the configuration's spin, mass, density unit and
    molecular weight, and its adiabatic index against plasma_gamma
    (warnings)."""
    fmt = cfg.require("simulation_format")
    kappa_name = None
    if cfg.require("plasma_model") == PlasmaModel.code_kappa:
        kappa_name = cfg.require("simulation_kappa_name")
    if fmt == SimulationFormat.athena:
        return load_athdf(path, kappa_name, device=device, dtype=dtype)
    if fmt == SimulationFormat.athenak:
        expected = {"a": cfg.require("simulation_a"),
                    "bhmass_msun": cfg.require("simulation_m_msun"),
                    "density_cgs": cfg.require("simulation_rho_cgs"),
                    "mu": cfg.require("plasma_mu")}
        return load_athenak(path, kappa_name, device=device, dtype=dtype,
                            plasma_gamma=cfg.plasma_gamma, expected=expected)
    if fmt == SimulationFormat.iharm3d:
        return load_iharm3d(path, cfg, device=device, dtype=dtype)
    return load_harm3d(path, cfg, device=device, dtype=dtype)


def load_grid(cfg, snapshot: Optional[int] = None, *, device,
              dtype) -> SimulationGrid:
    """Load the snapshot of one output run: ``simulation_file``, numbered
    from ``simulation_start`` when ``simulation_multiple`` is set
    (simulation_reader.cpp:305-307)."""
    path = cfg.require("simulation_file")
    if cfg.require("simulation_multiple") and snapshot is not None:
        path = format_filename(path, cfg.require("simulation_start")
                               + snapshot)
    return load_grid_file(cfg, path, device=device, dtype=dtype)


def make_simulation_coeff_fns(sp: simulation_kernel.SimKernelParams, grid,
                              frequencies, momentum_factors, spin: float,
                              camera_x, *, polarized: bool):
    """(coeff_fn, cell_fn) of the scan route
    (blacklight_tpu/pipeline_simulation.py:167-254) for a bundle with
    ``momentum_factors``; camera_x four Python floats.

    Unpolarized, coeff_fn(pos (B, 4), kcov four (B,)[, momentum_factors])
    is ``simulation_kernel.sample_coefficients``; polarized, coeff_fn(pos,
    kcov) on 4-tuples is ``polarized_kernel.polarized_coefficients``. The
    momentum factors are ``momentum_factors`` unless given: the scan
    route's bundle drops finished rays and passes its own.
    cell_fn(pos, kcov) gives the cell values, NaN where a cut holds or the
    reference would NaN the sample. The two share one grid sample and
    fluid state per sample: cell_fn called with the ``pos`` object of the
    last coeff_fn call reuses them.
    """
    nu0 = float(frequencies[0])
    last = {}

    def fluid_at(pos):
        if last.get("pos") is not pos:
            posb = torch.stack(pos, dim=-1) if polarized else pos
            last.update(pos=pos, fluid=simulation_kernel.fluid_sample(
                posb, sp, grid, spin, camera_x, zero_cut=polarized))
        return last["fluid"]

    def coeff_fn(pos, kcov, momentum_factors=momentum_factors):
        if polarized:
            return polarized_kernel.polarized_coefficients(
                pos, kcov, momentum_factors, frequencies, sp, grid, spin,
                camera_x, nu0, fluid=fluid_at(pos))
        return simulation_kernel.sample_coefficients(
            pos, kcov, momentum_factors, frequencies, sp, grid, spin,
            camera_x, nu0, fluid=fluid_at(pos))

    def cell_fn(pos, kcov):
        return simulation_kernel.cell_values(fluid_at(pos))

    return coeff_fn, cell_fn


def make_simulation_renderer(cfg, snapshot: Optional[int] = None, *, device,
                             grid: Optional[SimulationGrid] = None):
    """Build the simulation-model renderer on ``device``.

    grid: the snapshot on ``device`` (for example one built in memory with
    ``grid.athena.simulation_grid``); None loads it from ``cfg``.

    Returns (render_fn, geom, rays, frequencies, mass_msun), where
    render_fn(positions, directions, momentum_factors) renders a pixel
    bundle to a dict of tensors: "I_nu" (B, F) (and "Q_nu", "U_nu",
    "V_nu" with image_polarization; no light image with image_light =
    false), the auxiliary planes the config asks for, "rendering"
    (B, n_images, 3) with render_num_images > 0, "_flags" (B,) bool and
    "_n_samples" (B,). ``render_fn.route`` is "kernel" or "scan" (the
    module's docstring). On the kernel route it launches the bundle in
    ``spatial_order`` and returns it in the caller's order;
    ``render_fn.kernel`` is the kernel wrapper it calls
    (``render_simulation`` or ``render_polarized``; an unpolarized bundle
    that ``use_phased`` picks goes to ``render_simulation_phased`` with
    the same arguments; None on the scan route), with
    ``render_fn.kernel_args`` the arguments after the rays (the snapshot
    among them) and ``render_fn.kernel_kwargs`` the keywords.
    """
    from blacklight_tpu_torch import pipeline

    pipeline.check_slice(cfg)
    device = pipeline.resolve_device(device)
    dtype = pipeline.compute_dtype(cfg)
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    if grid is None:
        grid = load_grid(cfg, snapshot, device=device, dtype=dtype)
    if grid.prim.device != device:
        raise BlacklightError(f"the grid is on {grid.prim.device}, not "
                              f"{device}")
    # (blacklight_tpu/pipeline_simulation.py:174-178)
    coords = "cks" if cfg.require("simulation_coord") == Coordinates.cks \
        else "sks"
    if grid.coords != coords:
        raise BlacklightError(
            "simulation_coord does not match the loaded grid's coordinates.")
    if cfg.simulation_block_interp and cfg.require("simulation_interp"):
        # the neighbour table of exact interblock sampling
        # (blacklight_tpu/pipeline_simulation.py:297-301)
        grid = with_amr_table(grid)
    geom, rays, frequencies = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                          device=device, dtype=dtype)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    sp = simulation_kernel.sim_kernel_params(
        cfg, GeometricCuts.from_config(cfg), plasma_params_from_config(cfg),
        cut_params_from_config(cfg))
    sampling_mode(grid, sp.sampler)  # raises for a mode the grid lacks
    nu0 = float(frequencies[0])
    log_scale = synchrotron.log_j_scale(nu0)
    camera_x = geom.cam_x.tolist()
    kernel_args = (frequencies, params, sp, grid, mass_msun, camera_x,
                   log_scale)
    kernel_kwargs = {"integrator": params.integrator.value}
    fallback_nan = cfg.require("fallback_nan")
    opts = tu.ImageOptions.from_config(cfg)
    # (blacklight_tpu/pipeline_simulation.py:316-317)
    polarized = cfg.require("image_polarization") if opts.light else False
    render = None
    if cfg.require("render_num_images") > 0:
        render = rendering.Renderer(cfg.render_images, mass_msun, params)
    route = "scan" if opts.aux or not opts.light or render is not None \
        else "kernel"
    if route == "scan":
        kernel = None
    elif polarized:
        kernel = polarized_kernel.render_polarized
        kernel_kwargs["rotation_split"] = cfg.require("image_rotation_split")
    else:
        kernel = simulation_kernel.render_simulation

    def render_scan(positions, directions, momentum_factors):
        coeff_fn, cell_fn = make_simulation_coeff_fns(
            sp, grid, frequencies, momentum_factors, bh_a, camera_x,
            polarized=polarized)
        common = dict(params=params, integrator=kernel_kwargs["integrator"],
                      coeff_fn=coeff_fn, mass_msun=mass_msun, opts=opts,
                      cell_fn=cell_fn if opts.cells or render is not None
                      else None,
                      camera_x=camera_x, log_j_scale=log_scale)
        if not polarized:
            return tu.integrate_unpolarized(
                positions, directions, momentum_factors, frequencies,
                render=render, **common)
        if not opts.cells:
            common["cell_fn"] = None
        nn_re, nn_im, flags, n_samples, bad, planes = tp.integrate_polarized(
            positions, directions, momentum_factors, frequencies,
            rotation_split=cfg.require("image_rotation_split"), **common)
        image = polarized_kernel.poisoned_stokes(
            nn_re, nn_im, flags, bad, positions, directions, frequencies,
            params, geom, log_scale, fallback_nan)
        image = {**image, **planes, "_flags": flags, "_n_samples": n_samples}
        if render is not None:
            # the unpolarized cell values: the polarized sampler's zeroed
            # primitives at geometrically cut samples give NaN cells there
            # all the same
            _, cells_fn = make_simulation_coeff_fns(
                sp, grid, frequencies, momentum_factors, bh_a, camera_x,
                polarized=False)
            image["rendering"] = rendering.integrate_rendering(
                positions, directions, params, cells_fn, render.images,
                mass_msun, camera_x)[0]
        return image

    def render_fn(positions, directions, momentum_factors):
        if route == "scan":
            return render_scan(positions, directions, momentum_factors)
        # launched in spatial_order (blacklight_tpu/pipeline_simulation.py
        # :412-415, :513-517), returned in the caller's order
        order = simulation_kernel.spatial_order(positions,
                                                block=KERNEL_ORDER_BLOCK)
        rays = [t[order] for t in (positions, directions, momentum_factors)]
        if polarized:
            nn_re, nn_im, flags, n_samples, bad = kernel(
                *rays, *kernel_args, **kernel_kwargs)
            image = polarized_kernel.poisoned_stokes(
                nn_re, nn_im, flags, bad, rays[0], rays[1], frequencies,
                params, geom, log_scale, fallback_nan)
        elif use_phased(kernel_kwargs["integrator"], params.ray_max_steps,
                        positions.shape[0]):
            i_nu, flags, n_samples = \
                simulation_kernel.render_simulation_phased(
                    *rays, *kernel_args, **kernel_kwargs,
                    phase_steps=KERNEL_PHASE_STEPS, block=KERNEL_ORDER_BLOCK)
            image = {"I_nu": i_nu}
        else:
            i_nu, flags, n_samples = kernel(*rays, *kernel_args,
                                            **kernel_kwargs)
            image = {"I_nu": i_nu}
        out = {**image, "_flags": flags, "_n_samples": n_samples}
        return {k: _unorder(v, order) for k, v in out.items()}

    render_fn.route = route
    render_fn.kernel = kernel
    render_fn.kernel_args = kernel_args
    render_fn.kernel_kwargs = kernel_kwargs
    return render_fn, geom, rays, frequencies, mass_msun


def render_simulation_image(cfg, snapshot: Optional[int] = None, *, device):
    """Simulation-model image of the root camera (full-Stokes with
    image_polarization).

    Returns (image_dict, camera_rays, frequencies, mass_msun).
    """
    render_fn, geom, rays, frequencies, mass_msun = make_simulation_renderer(
        cfg, snapshot=snapshot, device=device)
    image = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    return image, rays, frequencies, mass_msun
