"""Adaptive image-plane block refinement.

Copy of ``blacklight_tpu/adaptive.py`` (pure numpy, no JAX), with its
import pointing at the port's ``utils/errors``. The reference's adaptive
machinery as a host-driven respawn loop over device-rendered pixel
bundles:
  - block evaluation criteria (src/radiation_integrator/radiation_adaptive.
    cpp:163-312 EvaluateBlock, :19-139 CheckAdaptiveRefinement) run
    vectorized over all blocks at once;
  - refined blocks spawn 4 children at doubled resolution
    (src/geodesic_integrator/camera.cpp:426-504 AugmentCamera), whose pixel
    bundle is handed back to the same render function
    (``pipeline.adaptive_loop``).

Evaluation happens on host NumPy: images are pulled back for output
anyway, the work is O(pixels), and the ragged flag->children expansion is
host logic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from blacklight_tpu_torch.utils.errors import BlacklightError


@dataclasses.dataclass(frozen=True)
class AdaptiveParams:
    """Adaptive options (reference input_reader.hpp:143-160, defaults
    radiation_integrator.cpp:150-233)."""

    max_level: int = 0
    block_size: int = 0
    frequency_num: int = 1      # 1-indexed frequency used for criteria
    val_cut: float = -1.0
    val_frac: float = -1.0
    abs_grad_cut: float = -1.0
    abs_grad_frac: float = -1.0
    rel_grad_cut: float = -1.0
    rel_grad_frac: float = -1.0
    abs_lapl_cut: float = -1.0
    abs_lapl_frac: float = -1.0
    rel_lapl_cut: float = -1.0
    rel_lapl_frac: float = -1.0
    regions: tuple = ()         # (level, x_min, x_max, y_min, y_max) tuples

    @staticmethod
    def from_config(cfg) -> "AdaptiveParams":
        max_level = cfg.require("adaptive_max_level")
        if max_level == 0:
            return AdaptiveParams()
        block_size = cfg.require("adaptive_block_size")
        resolution = cfg.require("camera_resolution")
        if resolution % block_size != 0:
            raise BlacklightError(
                "adaptive_block_size must divide camera_resolution.")
        num_regions = cfg.adaptive_num_regions or 0
        regions = tuple(
            (r.level, r.x_min, r.x_max, r.y_min, r.y_max)
            for r in (cfg.adaptive_regions or [])[:num_regions])

        def opt(name, default=-1.0):
            v = getattr(cfg, name)
            return default if v is None else v

        return AdaptiveParams(
            max_level=max_level, block_size=block_size,
            frequency_num=opt("adaptive_frequency_num", 1),
            val_cut=opt("adaptive_val_cut"), val_frac=opt("adaptive_val_frac"),
            abs_grad_cut=opt("adaptive_abs_grad_cut"),
            abs_grad_frac=opt("adaptive_abs_grad_frac"),
            rel_grad_cut=opt("adaptive_rel_grad_cut"),
            rel_grad_frac=opt("adaptive_rel_grad_frac"),
            abs_lapl_cut=opt("adaptive_abs_lapl_cut"),
            abs_lapl_frac=opt("adaptive_abs_lapl_frac"),
            rel_lapl_cut=opt("adaptive_rel_lapl_cut"),
            rel_lapl_frac=opt("adaptive_rel_lapl_frac"),
            regions=regions)


def root_block_locs(resolution: int, block_size: int) -> np.ndarray:
    """(B, 2) root-level block locations (v, u), row-major in v then u
    (radiation_adaptive.cpp:75-77 block indexing)."""
    linear = resolution // block_size
    v, u = np.divmod(np.arange(linear * linear), linear)
    return np.stack([v, u], axis=-1).astype(np.int32)


def _frac_exceeding(q, cut):
    """Fraction of finite entries of q exceeding cut, per block.

    q: (B, ...) with finite/NaN entries. Returns (B,) fractions
    (radiation_adaptive.cpp notes :149-162)."""
    finite = np.isfinite(q)
    num_examined = finite.reshape(q.shape[0], -1).sum(axis=-1)
    num_exceeded = (finite & (q > cut)).reshape(q.shape[0], -1).sum(axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return num_exceeded / num_examined


def evaluate_blocks(intensity: np.ndarray, p: AdaptiveParams) -> np.ndarray:
    """Refinement flags for a batch of blocks.

    intensity: (B, block_size, block_size) image of the criteria quantity
    (I_nu at the adaptive frequency; first Stokes component when
    polarized). Vectorized equivalent of EvaluateBlock
    (radiation_adaptive.cpp:163-312): each enabled test flags a block when
    the fraction of points with Q > cut exceeds frac.
    """
    B = intensity.shape[0]
    flags = np.zeros(B, dtype=bool)
    I = intensity

    if p.val_frac >= 0.0:
        flags |= _frac_exceeding(np.abs(I), p.val_cut) > p.val_frac

    if p.abs_grad_frac >= 0.0 or p.rel_grad_frac >= 0.0:
        # One-sided differences at edges, centered inside (:199-224)
        qx = np.empty_like(I)
        qx[:, :, 0] = I[:, :, 1] - I[:, :, 0]
        qx[:, :, -1] = I[:, :, -1] - I[:, :, -2]
        qx[:, :, 1:-1] = 0.5 * (I[:, :, 2:] - I[:, :, :-2])
        qy = np.empty_like(I)
        qy[:, 0, :] = I[:, 1, :] - I[:, 0, :]
        qy[:, -1, :] = I[:, -1, :] - I[:, -2, :]
        qy[:, 1:-1, :] = 0.5 * (I[:, 2:, :] - I[:, :-2, :])
        if p.abs_grad_frac >= 0.0:
            flags |= _frac_exceeding(np.hypot(qx, qy),
                                     p.abs_grad_cut) > p.abs_grad_frac
        if p.rel_grad_frac >= 0.0:
            # Unhalved centered difference for the rel-grad numerator
            # (radiation_adaptive.cpp:225-250): interior q_x is
            # 2*(I2-I0)/(I0+2*I1+I2), i.e. the numerator is the FULL
            # centered difference, unlike abs-grad's 0.5*(I2-I0).
            gx = np.empty_like(I)
            gx[:, :, 0] = I[:, :, 1] - I[:, :, 0]
            gx[:, :, -1] = I[:, :, -1] - I[:, :, -2]
            gx[:, :, 1:-1] = I[:, :, 2:] - I[:, :, :-2]
            gy = np.empty_like(I)
            gy[:, 0, :] = I[:, 1, :] - I[:, 0, :]
            gy[:, -1, :] = I[:, -1, :] - I[:, -2, :]
            gy[:, 1:-1, :] = I[:, 2:, :] - I[:, :-2, :]
            dx = np.empty_like(I)
            dx[:, :, 0] = I[:, :, 0] + I[:, :, 1]
            dx[:, :, -1] = I[:, :, -2] + I[:, :, -1]
            dx[:, :, 1:-1] = I[:, :, :-2] + 2.0 * I[:, :, 1:-1] + I[:, :, 2:]
            dy = np.empty_like(I)
            dy[:, 0, :] = I[:, 0, :] + I[:, 1, :]
            dy[:, -1, :] = I[:, -2, :] + I[:, -1, :]
            dy[:, 1:-1, :] = I[:, :-2, :] + 2.0 * I[:, 1:-1, :] + I[:, 2:, :]
            with np.errstate(invalid="ignore", divide="ignore"):
                q = np.hypot(2.0 * gx / dx, 2.0 * gy / dy)
            flags |= _frac_exceeding(q, p.rel_grad_cut) > p.rel_grad_frac

    if p.abs_lapl_frac >= 0.0 or p.rel_lapl_frac >= 0.0:
        lx = I[:, 1:-1, :-2] - 2.0 * I[:, 1:-1, 1:-1] + I[:, 1:-1, 2:]
        ly = I[:, :-2, 1:-1] - 2.0 * I[:, 1:-1, 1:-1] + I[:, 2:, 1:-1]
        if p.abs_lapl_frac >= 0.0:
            flags |= _frac_exceeding(np.abs(lx + ly),
                                     p.abs_lapl_cut) > p.abs_lapl_frac
        if p.rel_lapl_frac >= 0.0:
            sx = I[:, 1:-1, :-2] + 2.0 * I[:, 1:-1, 1:-1] + I[:, 1:-1, 2:]
            sy = I[:, :-2, 1:-1] + 2.0 * I[:, 1:-1, 1:-1] + I[:, 2:, 1:-1]
            with np.errstate(invalid="ignore", divide="ignore"):
                q = np.abs(4.0 * lx / sx + 4.0 * ly / sy)
            flags |= _frac_exceeding(q, p.rel_lapl_cut) > p.rel_lapl_frac

    return flags


def forced_flags(block_locs: np.ndarray, level: int, linear_num_blocks: int,
                 camera_width: float, p: AdaptiveParams) -> np.ndarray:
    """Forced-region refinement flags (radiation_adaptive.cpp:51-69,
    96-114): a block is forced if its center lies in a region whose
    minimum level exceeds the current level."""
    B = block_locs.shape[0]
    flags = np.zeros(B, dtype=bool)
    if not p.regions:
        return flags
    y = ((block_locs[:, 0] + 0.5) / linear_num_blocks - 0.5) * camera_width
    x = ((block_locs[:, 1] + 0.5) / linear_num_blocks - 0.5) * camera_width
    for (min_level, x_min, x_max, y_min, y_max) in p.regions:
        flags |= ((level < min_level) & (x > x_min) & (x < x_max)
                  & (y > y_min) & (y < y_max))
    return flags


def check_refinement(intensity_blocks: np.ndarray, block_locs: np.ndarray,
                     level: int, resolution: int, camera_width: float,
                     p: AdaptiveParams) -> np.ndarray:
    """Full per-level refinement decision: forced regions OR criteria
    (CheckAdaptiveRefinement, radiation_adaptive.cpp:19-139)."""
    linear_num_blocks = (resolution // p.block_size) * (1 << level)
    forced = forced_flags(block_locs, level, linear_num_blocks,
                          camera_width, p)
    flags = evaluate_blocks(intensity_blocks, p)
    return forced | flags


def child_block_locs(block_locs: np.ndarray, flags: np.ndarray) -> np.ndarray:
    """(4*refined, 2) child block locations in the reference's order:
    flagged parents in order; per parent children at (2v, 2u), (2v, 2u+1),
    (2v+1, 2u), (2v+1, 2u+1) (camera.cpp:455-460)."""
    parents = block_locs[flags]
    v = parents[:, 0:1] * 2
    u = parents[:, 1:2] * 2
    children = np.concatenate([
        np.concatenate([v, u], axis=-1)[:, None, :],
        np.concatenate([v, u + 1], axis=-1)[:, None, :],
        np.concatenate([v + 1, u], axis=-1)[:, None, :],
        np.concatenate([v + 1, u + 1], axis=-1)[:, None, :],
    ], axis=1)
    return children.reshape(-1, 2).astype(np.int32)


def extract_root_blocks(image_flat: np.ndarray, resolution: int,
                        block_size: int) -> np.ndarray:
    """(B, bs, bs) blocks from a flat root image (row-major pixels),
    matching root_block_locs order (radiation_adaptive.cpp:75-85)."""
    linear = resolution // block_size
    img = image_flat.reshape(resolution, resolution)
    blocks = img.reshape(linear, block_size, linear, block_size)
    return blocks.transpose(0, 2, 1, 3).reshape(-1, block_size, block_size)


def blocks_from_bundle(image_flat: np.ndarray, num_blocks: int,
                       block_size: int) -> np.ndarray:
    """(B, bs, bs) blocks from a level>0 pixel bundle (block-major then
    row-major within block, as produced by camera.block_pixel_grid)."""
    return image_flat.reshape(num_blocks, block_size, block_size)
