"""Output writing: npz / npy / raw with reference-compatible array names.

The reference hand-rolls NPY v1 + ZIP 2.0 (src/output_writer/
numpy_format.cpp, zip_format.cpp); NumPy's own savez produces the identical
container, so here the work is assembling the arrays with the reference's
names and shapes (numpy_format.cpp:71-527) and validating format/feature
compatibility (output_writer.cpp:39-112).
"""

from __future__ import annotations

import io
import os
import re
from typing import Optional

import numpy as np

from blacklight_tpu_torch.constants import (
    CELL_VALUE_NAMES,
    CameraType,
    ModelType,
    OutputFormat,
)
from blacklight_tpu_torch.utils.errors import BlacklightError


def validate_output_options(cfg) -> None:
    """Format/feature compatibility (reference output_writer.cpp:39-112)."""
    fmt = cfg.require("output_format")
    if cfg.require("image_num_frequencies") > 1 and fmt != OutputFormat.npz:
        raise BlacklightError("Only npz support multiple frequencies.")
    if cfg.require("image_light") and cfg.model_type == ModelType.simulation:
        if cfg.require("image_polarization") and fmt not in (OutputFormat.npz,
                                                             OutputFormat.npy):
            raise BlacklightError("Only npz or npy outputs support polarization.")
    non_light = any(bool(getattr(cfg, k)) for k in (
        "image_time", "image_length", "image_lambda", "image_emission",
        "image_tau", "image_lambda_ave", "image_emission_ave", "image_tau_int",
        "image_crossings"))
    if non_light and fmt != OutputFormat.npz:
        raise BlacklightError("Only npz outputs support non-light images.")
    if (cfg.require("render_num_images") > 0) and fmt != OutputFormat.npz:
        raise BlacklightError("Only npz outputs support rendering.")
    if cfg.require("adaptive_max_level") > 0 and fmt != OutputFormat.npz:
        raise BlacklightError("Only npz outputs support adaptive ray tracing.")


def format_filename(template: str, snapshot: Optional[int]) -> str:
    """Expand ``{Nd}``-style numbered filename patterns
    (reference simulation_reader.cpp:870-904 applied to outputs,
    output_writer.cpp:283-316)."""
    if snapshot is None:
        return template
    m = re.search(r"\{([0-9]*)d\}", template)
    if m is None:
        return template
    width = int(m.group(1)) if m.group(1) else 0
    return template[: m.start()] + f"{snapshot:0{width}d}" + template[m.end():]


def assemble_npz_arrays(cfg, image_dict, *, mass_msun: float, frequencies,
                        camera_rays=None, rendering=None,
                        adaptive_levels=None) -> dict:
    """Build the named array dict for the npz output (root level).

    Args:
      image_dict: outputs of the transfer integrators, keyed "I_nu",
        "Q_nu", "U_nu", "V_nu", "time", "length", "lambda", "emission",
        "tau", "lambda_ave", "emission_ave", "tau_int", "crossings";
        image-plane arrays are (num_pix,) / (num_pix, F) / (num_pix, F, C).
      camera_rays: CameraRays for output_camera.
      rendering: optional (num_images, 3, num_pix) false-color data.
      adaptive_levels: optional list of per-level dicts, each with keys
        "block_locs" (B,2), "positions"/"directions", and the same image
        quantities with block-shaped pixels; appended as adaptive_*_<level>.
    """
    res = cfg.require("camera_resolution")
    num_freq = cfg.require("image_num_frequencies")
    out = {}
    out["mass_msun"] = np.array([mass_msun])
    out["width"] = np.array([cfg.require("camera_width")])
    out["frequency"] = np.asarray(frequencies)
    num_levels = len(adaptive_levels) if adaptive_levels else 0
    out["adaptive_num_levels"] = np.array([num_levels], dtype=np.int32)
    if cfg.require("adaptive_max_level") > 0:
        linear = res // cfg.require("adaptive_block_size")
        counts = [linear * linear] \
            + [lvl["num_blocks"] for lvl in (adaptive_levels or [])]
        out["adaptive_num_blocks"] = np.array(counts, dtype=np.int32)

    def reshape_freq(arr):
        """(num_pix, F) -> (res, res) or (F, res, res) (numpy_format.cpp:128-135)."""
        a = np.asarray(arr)
        if num_freq == 1:
            return a[:, 0].reshape(res, res)
        return np.moveaxis(a, -1, 0).reshape(num_freq, res, res)

    if cfg.require("output_camera") and camera_rays is not None:
        if cfg.require("camera_type") == CameraType.plane:
            out["positions"] = np.asarray(camera_rays.positions).reshape(res, res, 4)
        else:
            out["directions"] = np.asarray(camera_rays.directions).reshape(res, res, 4)

    if cfg.require("image_light"):
        out["I_nu"] = reshape_freq(image_dict["I_nu"])
        for stokes in ("Q_nu", "U_nu", "V_nu"):
            if stokes in image_dict:
                out[stokes] = reshape_freq(image_dict[stokes])
    if "time" in image_dict:
        out["time"] = np.asarray(image_dict["time"]).reshape(res, res)
    if "length" in image_dict:
        out["length"] = np.asarray(image_dict["length"]).reshape(res, res)
    if "lambda" in image_dict:
        out["lambda"] = reshape_freq(image_dict["lambda"])
    if "emission" in image_dict:
        out["emission"] = reshape_freq(image_dict["emission"])
    if "tau" in image_dict:
        out["tau"] = reshape_freq(image_dict["tau"])
    for prefix in ("lambda_ave", "emission_ave", "tau_int"):
        if prefix in image_dict:
            arr = np.asarray(image_dict[prefix])  # (num_pix, F, C)
            for c, name in enumerate(CELL_VALUE_NAMES):
                out[f"{prefix}_{name}"] = reshape_freq(arr[..., c])
    if "crossings" in image_dict:
        out["crossings"] = np.asarray(image_dict["crossings"]).reshape(res, res)
    if rendering is not None:
        n_img = rendering.shape[0]
        out["rendering"] = np.asarray(rendering).reshape(n_img, 3, res, res)

    for level, lvl in enumerate(adaptive_levels or [], start=1):
        out[f"adaptive_block_locs_{level}"] = np.asarray(
            lvl["block_locs"], dtype=np.int32)
        for key, arr in lvl.items():
            if key in ("block_locs", "num_blocks"):
                continue
            out[f"adaptive_{key}_{level}"] = np.asarray(arr)
    return out


def shape_adaptive_level(cfg, image_dict, num_blocks: int, block_size: int,
                         camera_rays=None, rendering=None) -> dict:
    """Reshape one adaptive level's pixel-bundle images into the
    block-shaped arrays the reference writes (numpy_format.cpp:291-527,
    shapes set in output_writer.cpp:182-246): pixel axis becomes
    (num_blocks, block_size, block_size)."""
    num_freq = cfg.require("image_num_frequencies")
    bs = block_size
    out = {}

    def reshape_freq(arr):
        a = np.asarray(arr)
        if num_freq == 1:
            return a[:, 0].reshape(num_blocks, bs, bs)
        return np.moveaxis(a, -1, 0).reshape(num_freq, num_blocks, bs, bs)

    if cfg.require("output_camera") and camera_rays is not None:
        if cfg.require("camera_type") == CameraType.plane:
            out["positions"] = np.asarray(
                camera_rays.positions).reshape(num_blocks, bs, bs, 4)
        else:
            out["directions"] = np.asarray(
                camera_rays.directions).reshape(num_blocks, bs, bs, 4)
    if cfg.require("image_light") and "I_nu" in image_dict:
        out["I_nu"] = reshape_freq(image_dict["I_nu"])
        for stokes in ("Q_nu", "U_nu", "V_nu"):
            if stokes in image_dict:
                out[stokes] = reshape_freq(image_dict[stokes])
    for key in ("time", "length", "crossings"):
        if key in image_dict:
            out[key] = np.asarray(image_dict[key]).reshape(num_blocks, bs, bs)
    for key in ("lambda", "emission", "tau"):
        if key in image_dict:
            out[key] = reshape_freq(image_dict[key])
    for prefix in ("lambda_ave", "emission_ave", "tau_int"):
        if prefix in image_dict:
            arr = np.asarray(image_dict[prefix])  # (num_pix, F, C)
            for c, name in enumerate(CELL_VALUE_NAMES):
                out[f"{prefix}_{name}"] = reshape_freq(arr[..., c])
    if rendering is not None:
        n_img = rendering.shape[0]
        out["rendering"] = np.asarray(rendering).reshape(
            n_img, 3, num_blocks, bs, bs)
    return out


def write_output(cfg, path: str, arrays: dict, image_packed=None) -> None:
    """Write npz / npy / raw output (reference output_writer.cpp:261-266)."""
    fmt = cfg.require("output_format")
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    if fmt == OutputFormat.npz:
        # np.savez writes uncompressed ZIP (store), like the reference.
        np.savez(path, **arrays)
    elif fmt == OutputFormat.npy:
        np.save(path, np.asarray(image_packed))
    else:  # raw
        with open(path, "wb") as fobj:
            fobj.write(np.ascontiguousarray(image_packed).tobytes())
