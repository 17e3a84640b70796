"""Input-file configuration system.

Parses the reference's plain-text ``key = value  # comment`` input format
(reference src/input_reader/input_reader.cpp:72-428) into a typed Config
object, preserving:

- deferred validation: every field is Optional; consumers call
  :meth:`Config.require` for what they need (mirroring std::optional.value()),
- degree->radian conversion for camera_th/camera_ph/camera_rotation/
  cut_midplane_theta (input_reader.cpp:185-201, 388-389),
- pole detection for camera_th in {0, 180} degrees (input_reader.cpp:492-500),
- comma triples for cut_plane_origin/normal (input_reader.cpp:468-482),
- indexed render keys render_<i>_<f>_* (render_reader.cpp:27-224) and
  adaptive region keys adaptive_region_<n>_* (adaptive_reader.cpp:27-93),
- num_runs computation (input_reader.cpp:419-427).

New (TPU-specific) keys, all optional:
- precision      = float64 | float32   (compute dtype; default float64)
- ray_scan_chunk = int                 (pixels per fused-scan shard chunk)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from blacklight_tpu_torch.constants import (
    CameraType,
    CellValues,
    Coordinates,
    FrequencyNormalization,
    FrequencySpacing,
    ModelType,
    OutputFormat,
    PlasmaModel,
    RayIntegrator,
    RayTerminate,
    RenderType,
    SimulationFormat,
)
from blacklight_tpu_torch.utils.colors import rgb_to_xyz
from blacklight_tpu_torch.utils.errors import BlacklightError

DEG = math.pi / 180.0


@dataclasses.dataclass
class RenderFeature:
    """One feature of a false-color rendering (render_reader.cpp fields)."""

    quantity: Optional[int] = None        # CellValues index
    render_type: Optional[RenderType] = None
    min_val: Optional[float] = None
    max_val: Optional[float] = None
    thresh_val: Optional[float] = None
    tau_scale: Optional[float] = None
    opacity: Optional[float] = None
    x_val: Optional[float] = None
    y_val: Optional[float] = None
    z_val: Optional[float] = None


@dataclasses.dataclass
class RenderImage:
    num_features: Optional[int] = None
    features: list[RenderFeature] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AdaptiveRegion:
    level: Optional[int] = None
    x_min: Optional[float] = None
    x_max: Optional[float] = None
    y_min: Optional[float] = None
    y_max: Optional[float] = None


@dataclasses.dataclass
class Config:
    """All input parameters (reference input_reader.hpp:27-214)."""

    input_file: str = ""

    # General
    model_type: Optional[ModelType] = None
    num_threads: Optional[int] = None

    # Output
    output_format: Optional[OutputFormat] = None
    output_file: Optional[str] = None
    output_camera: Optional[bool] = None

    # Checkpoints
    checkpoint_geodesic_save: Optional[bool] = None
    checkpoint_geodesic_load: Optional[bool] = None
    checkpoint_geodesic_file: Optional[str] = None
    checkpoint_sample_save: Optional[bool] = None
    checkpoint_sample_load: Optional[bool] = None
    checkpoint_sample_file: Optional[str] = None

    # Simulation
    simulation_format: Optional[SimulationFormat] = None
    simulation_file: Optional[str] = None
    simulation_multiple: Optional[bool] = None
    simulation_start: Optional[int] = None
    simulation_end: Optional[int] = None
    simulation_coord: Optional[Coordinates] = None
    simulation_a: Optional[float] = None
    simulation_m_msun: Optional[float] = None
    simulation_rho_cgs: Optional[float] = None
    simulation_kappa_name: Optional[str] = None
    simulation_interp: Optional[bool] = None
    simulation_block_interp: Optional[bool] = None

    # Formula
    formula_mass: Optional[float] = None
    formula_spin: Optional[float] = None
    formula_r0: Optional[float] = None
    formula_h: Optional[float] = None
    formula_l0: Optional[float] = None
    formula_q: Optional[float] = None
    formula_nup: Optional[float] = None
    formula_cn0: Optional[float] = None
    formula_alpha: Optional[float] = None
    formula_a: Optional[float] = None
    formula_beta: Optional[float] = None

    # Camera
    camera_type: Optional[CameraType] = None
    camera_r: Optional[float] = None
    camera_th: Optional[float] = None            # radians
    camera_ph: Optional[float] = None            # radians
    camera_urn: Optional[float] = None
    camera_uthn: Optional[float] = None
    camera_uphn: Optional[float] = None
    camera_k_r: Optional[float] = None
    camera_k_th: Optional[float] = None
    camera_k_ph: Optional[float] = None
    camera_rotation: Optional[float] = None      # radians
    camera_width: Optional[float] = None
    camera_resolution: Optional[int] = None
    camera_pole: Optional[bool] = None

    # Ray tracing
    ray_flat: Optional[bool] = None
    ray_terminate: Optional[RayTerminate] = None
    ray_factor: Optional[float] = None
    ray_integrator: Optional[RayIntegrator] = None
    ray_step: Optional[float] = None
    ray_max_steps: Optional[int] = None
    ray_max_retries: Optional[int] = None
    ray_tol_abs: Optional[float] = None
    ray_tol_rel: Optional[float] = None

    # Image
    image_light: Optional[bool] = None
    image_num_frequencies: Optional[int] = None
    image_frequency: Optional[float] = None
    image_frequency_start: Optional[float] = None
    image_frequency_end: Optional[float] = None
    image_frequency_spacing: Optional[FrequencySpacing] = None
    image_normalization: Optional[FrequencyNormalization] = None
    image_polarization: Optional[bool] = None
    image_rotation_split: Optional[bool] = None
    image_time: Optional[bool] = None
    image_length: Optional[bool] = None
    image_lambda: Optional[bool] = None
    image_emission: Optional[bool] = None
    image_tau: Optional[bool] = None
    image_lambda_ave: Optional[bool] = None
    image_emission_ave: Optional[bool] = None
    image_tau_int: Optional[bool] = None
    image_crossings: Optional[bool] = None

    # Rendering
    render_num_images: Optional[int] = None
    render_images: list[RenderImage] = dataclasses.field(default_factory=list)

    # Slow light
    slow_light_on: Optional[bool] = None
    slow_interp: Optional[bool] = None
    slow_chunk_size: Optional[int] = None
    slow_t_start: Optional[float] = None
    slow_dt: Optional[float] = None
    slow_num_images: Optional[int] = None
    slow_offset: Optional[int] = None

    # Adaptive
    adaptive_max_level: Optional[int] = None
    adaptive_block_size: Optional[int] = None
    adaptive_frequency_num: Optional[int] = None
    adaptive_val_cut: Optional[float] = None
    adaptive_val_frac: Optional[float] = None
    adaptive_abs_grad_cut: Optional[float] = None
    adaptive_abs_grad_frac: Optional[float] = None
    adaptive_rel_grad_cut: Optional[float] = None
    adaptive_rel_grad_frac: Optional[float] = None
    adaptive_abs_lapl_cut: Optional[float] = None
    adaptive_abs_lapl_frac: Optional[float] = None
    adaptive_rel_lapl_cut: Optional[float] = None
    adaptive_rel_lapl_frac: Optional[float] = None
    adaptive_num_regions: Optional[int] = None
    adaptive_regions: list[AdaptiveRegion] = dataclasses.field(default_factory=list)

    # Plasma
    plasma_mu: Optional[float] = None
    plasma_ne_ni: Optional[float] = None
    plasma_model: Optional[PlasmaModel] = None
    plasma_use_p: Optional[bool] = None
    plasma_gamma: Optional[float] = None
    plasma_gamma_i: Optional[float] = None
    plasma_gamma_e: Optional[float] = None
    plasma_rat_low: Optional[float] = None
    plasma_rat_high: Optional[float] = None
    plasma_power_frac: Optional[float] = None
    plasma_p: Optional[float] = None
    plasma_gamma_min: Optional[float] = None
    plasma_gamma_max: Optional[float] = None
    plasma_kappa_frac: Optional[float] = None
    plasma_kappa: Optional[float] = None
    plasma_w: Optional[float] = None

    # Cuts
    cut_rho_min: Optional[float] = None
    cut_rho_max: Optional[float] = None
    cut_n_e_min: Optional[float] = None
    cut_n_e_max: Optional[float] = None
    cut_p_gas_min: Optional[float] = None
    cut_p_gas_max: Optional[float] = None
    cut_theta_e_min: Optional[float] = None
    cut_theta_e_max: Optional[float] = None
    cut_b_min: Optional[float] = None
    cut_b_max: Optional[float] = None
    cut_sigma_min: Optional[float] = None
    cut_sigma_max: Optional[float] = None
    cut_beta_inverse_min: Optional[float] = None
    cut_beta_inverse_max: Optional[float] = None
    cut_omit_near: Optional[bool] = None
    cut_omit_far: Optional[bool] = None
    cut_omit_in: Optional[float] = None
    cut_omit_out: Optional[float] = None
    cut_midplane_theta: Optional[float] = None   # radians
    cut_midplane_z: Optional[float] = None
    cut_plane: Optional[bool] = None
    cut_plane_origin_x: Optional[float] = None
    cut_plane_origin_y: Optional[float] = None
    cut_plane_origin_z: Optional[float] = None
    cut_plane_normal_x: Optional[float] = None
    cut_plane_normal_y: Optional[float] = None
    cut_plane_normal_z: Optional[float] = None

    # Fallbacks
    fallback_nan: Optional[bool] = None
    fallback_rho: Optional[float] = None
    fallback_pgas: Optional[float] = None
    fallback_kappa: Optional[float] = None

    # TPU-specific extensions (not in reference)
    precision: Optional[str] = None              # "float64" (default) | "float32"
    ray_scan_chunk: Optional[int] = None         # pixels per device chunk

    # Derived
    num_runs: int = 1

    def require(self, name: str):
        """Fetch a field, raising the reference's friendly error if unset."""
        val = getattr(self, name)
        if val is None:
            raise BlacklightError(
                f"Must specify {name} in input file for this configuration."
            )
        return val


_ENUM_FIELDS = {
    "model_type": ModelType,
    "output_format": OutputFormat,
    "simulation_format": SimulationFormat,
    "simulation_coord": Coordinates,
    "camera_type": CameraType,
    "ray_terminate": RayTerminate,
    "ray_integrator": RayIntegrator,
    "image_frequency_spacing": FrequencySpacing,
    "image_normalization": FrequencyNormalization,
    "plasma_model": PlasmaModel,
}

_BOOL_FIELDS = {
    "output_camera", "checkpoint_geodesic_save", "checkpoint_geodesic_load",
    "checkpoint_sample_save", "checkpoint_sample_load", "simulation_multiple",
    "simulation_interp", "simulation_block_interp", "ray_flat", "image_light",
    "image_polarization", "image_rotation_split", "image_time", "image_length",
    "image_lambda", "image_emission", "image_tau", "image_lambda_ave",
    "image_emission_ave", "image_tau_int", "image_crossings", "slow_light_on",
    "slow_interp", "plasma_use_p", "cut_omit_near", "cut_omit_far", "cut_plane",
    "fallback_nan",
}

_INT_FIELDS = {
    "num_threads", "simulation_start", "simulation_end", "camera_resolution",
    "ray_max_steps", "ray_max_retries", "image_num_frequencies",
    "slow_chunk_size", "slow_num_images", "slow_offset", "adaptive_max_level",
    "adaptive_block_size", "adaptive_frequency_num", "ray_scan_chunk",
}

_STR_FIELDS = {
    "output_file", "checkpoint_geodesic_file", "checkpoint_sample_file",
    "simulation_file", "simulation_kappa_name", "precision",
}

_DEGREE_FIELDS = {"camera_ph", "camera_rotation", "cut_midplane_theta"}

_RENDER_QUANTITIES = {
    "rho": CellValues.rho,
    "n_e": CellValues.n_e,
    "p_gas": CellValues.p_gas,
    "Theta_e": CellValues.theta_e,
    "B": CellValues.bb,
    "sigma": CellValues.sigma,
    "beta_inverse": CellValues.beta_inv,
}


def _read_bool(val: str) -> bool:
    """"true"/"false" only (input_reader.cpp:451-461)."""
    if val == "true":
        return True
    if val == "false":
        return False
    raise BlacklightError("Unknown string used for boolean value.")


def _read_triple(val: str) -> tuple[float, float, float]:
    parts = val.split(",")
    if len(parts) != 3:
        raise BlacklightError(f"Invalid triple ({val}) in input file.")
    return float(parts[0]), float(parts[1]), float(parts[2])


def _parse_render_key(cfg: Config, key: str, val: str) -> None:
    """Handle render_* keys (render_reader.cpp:27-224). key has 'render_' stripped."""
    if key == "num_images":
        cfg.render_num_images = int(val)
        cfg.render_images = [RenderImage() for _ in range(max(cfg.render_num_images, 0))]
        return
    if key.endswith("_num_features"):
        image_num = int(key[: -len("_num_features")]) - 1
        if image_num >= (cfg.render_num_images or 0):
            return
        n = int(val)
        cfg.render_images[image_num].num_features = n
        cfg.render_images[image_num].features = [RenderFeature() for _ in range(n)]
        return

    # Remaining keys look like "<i>_<f>_<field>"
    parts = key.split("_", 2)
    if len(parts) < 3:
        raise BlacklightError(f"Unknown key (render_{key}) in input file.")
    image_num = int(parts[0]) - 1
    feature_num = int(parts[1]) - 1
    field = parts[2]
    if image_num >= (cfg.render_num_images or 0):
        return
    img = cfg.render_images[image_num]
    if img.num_features is None or feature_num >= img.num_features:
        return
    feat = img.features[feature_num]
    if field == "quantity":
        if val not in _RENDER_QUANTITIES:
            raise BlacklightError(f"Invalid render quantity ({val}) in input file.")
        feat.quantity = int(_RENDER_QUANTITIES[val])
    elif field == "type":
        try:
            feat.render_type = RenderType(val)
        except ValueError:
            raise BlacklightError(f"Invalid render type ({val}) in input file.")
    elif field == "min":
        feat.min_val = float(val)
    elif field == "max":
        feat.max_val = float(val)
    elif field == "thresh":
        feat.thresh_val = float(val)
    elif field == "tau_scale":
        feat.tau_scale = float(val)
    elif field == "opacity":
        feat.opacity = float(val)
    elif field == "rgb":
        r, g, b = _read_triple(val)
        feat.x_val, feat.y_val, feat.z_val = rgb_to_xyz(r, g, b)
    elif field == "xyz":
        feat.x_val, feat.y_val, feat.z_val = _read_triple(val)
    else:
        raise BlacklightError(f"Unknown key (render_{key}) in input file.")


def _parse_adaptive_region_key(cfg: Config, key: str, val: str) -> None:
    """Handle adaptive_region_* / adaptive_num_regions keys (adaptive_reader.cpp)."""
    if key == "num_regions":
        cfg.adaptive_num_regions = int(val)
        cfg.adaptive_regions = [
            AdaptiveRegion() for _ in range(max(cfg.adaptive_num_regions, 0))
        ]
        return
    for suffix, field in (
        ("_level", "level"), ("_x_min", "x_min"), ("_x_max", "x_max"),
        ("_y_min", "y_min"), ("_y_max", "y_max"),
    ):
        if key.endswith(suffix):
            region_num = int(key[: -len(suffix)]) - 1
            if region_num >= (cfg.adaptive_num_regions or 0):
                return
            value = int(val) if field == "level" else float(val)
            setattr(cfg.adaptive_regions[region_num], field, value)
            return
    raise BlacklightError(f"Unknown key (adaptive_region_{key}) in input file.")


def parse_config(text: str, input_file: str = "") -> Config:
    """Parse input-file text into a Config (input_reader.cpp:72-428)."""
    cfg = Config(input_file=input_file)
    field_names = {f.name for f in dataclasses.fields(Config)}

    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0]
        if "=" not in line:
            if line.strip():
                raise BlacklightError(f"Invalid line in input file: {raw_line!r}")
            continue
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if not key:
            raise BlacklightError(f"Invalid line in input file: {raw_line!r}")

        if key == "camera_th":
            v = float(val)
            cfg.camera_pole = v in (0.0, 180.0)
            cfg.camera_th = v * DEG
        elif key in _DEGREE_FIELDS:
            setattr(cfg, key, float(val) * DEG)
        elif key == "cut_plane_origin":
            (cfg.cut_plane_origin_x, cfg.cut_plane_origin_y,
             cfg.cut_plane_origin_z) = _read_triple(val)
        elif key == "cut_plane_normal":
            (cfg.cut_plane_normal_x, cfg.cut_plane_normal_y,
             cfg.cut_plane_normal_z) = _read_triple(val)
        elif key.startswith("render_"):
            _parse_render_key(cfg, key[len("render_"):], val)
        elif key == "adaptive_num_regions" or key.startswith("adaptive_region_"):
            sub = key[len("adaptive_region_"):] if key.startswith("adaptive_region_") \
                else "num_regions"
            _parse_adaptive_region_key(cfg, sub, val)
        elif key in _ENUM_FIELDS:
            try:
                setattr(cfg, key, _ENUM_FIELDS[key](val))
            except ValueError:
                raise BlacklightError(f"Invalid {key} ({val}) in input file.")
        elif key in _BOOL_FIELDS:
            setattr(cfg, key, _read_bool(val))
        elif key in _INT_FIELDS:
            setattr(cfg, key, int(val))
        elif key in _STR_FIELDS:
            setattr(cfg, key, val)
        elif key in field_names:
            setattr(cfg, key, float(val))
        else:
            raise BlacklightError(f"Unknown key ({key}) in input file.")

    # Count runs (input_reader.cpp:419-427)
    cfg.num_runs = 1
    if cfg.model_type == ModelType.simulation and cfg.require("simulation_multiple"):
        if cfg.require("slow_light_on"):
            cfg.num_runs = cfg.require("slow_num_images")
        else:
            cfg.num_runs = cfg.require("simulation_end") - cfg.require("simulation_start") + 1
    return cfg


def read_config(path: str) -> Config:
    """Read and parse an input file from disk."""
    with open(path, "r") as f:
        return parse_config(f.read(), input_file=path)


def warn_ignored_options(cfg: Config) -> None:
    """Warn about options that are set but ignored for this run, mirroring
    the reference's "Ignoring ... selection." warnings
    (radiation_integrator.cpp:44-143, simulation_reader.cpp:92-147)."""
    from blacklight_tpu_torch.constants import (ModelType, PlasmaModel,
                                                SimulationFormat)
    from blacklight_tpu_torch.utils.errors import blacklight_warning

    simulation = cfg.model_type == ModelType.simulation
    if not simulation:
        if cfg.checkpoint_sample_save:
            blacklight_warning("Ignoring checkpoint_sample_save selection.")
        if cfg.checkpoint_sample_load:
            blacklight_warning("Ignoring checkpoint_sample_load selection.")
        for key in ("image_lambda_ave", "image_emission_ave", "image_tau_int"):
            if getattr(cfg, key):
                blacklight_warning(f"Ignoring {key} selection.")
        if (cfg.render_num_images or 0) > 0:
            blacklight_warning("Ignoring request for rendering.")
    else:
        block_capable = cfg.simulation_format in (SimulationFormat.athena,
                                                  SimulationFormat.athenak)
        if cfg.simulation_block_interp is not None and not (
                block_capable and cfg.simulation_interp):
            blacklight_warning("Ignoring simulation_block_interp selection.")
        if cfg.plasma_model == PlasmaModel.ti_te_beta and cfg.plasma_use_p \
                or cfg.plasma_model == PlasmaModel.code_kappa:
            if cfg.plasma_gamma_i is not None:
                blacklight_warning("Ignoring plasma_gamma_i selection.")
            if cfg.plasma_gamma_e is not None:
                blacklight_warning("Ignoring plasma_gamma_e selection.")
    if cfg.image_polarization and not (simulation and cfg.image_light):
        blacklight_warning("Ignoring image_polarization selection.")
