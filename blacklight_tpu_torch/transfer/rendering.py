"""False-color volume rendering, streamed camera to far end.

Port of ``blacklight_tpu/transfer/rendering.py`` (``DELTA_TAU_MAX``,
``integrate_rendering``; the reference is rendering.cpp:25-179): each
image's XYZ color along a ray from the cell values of its samples.
``fill`` features accumulate color weighted by optical depth (tau is the
proper length over tau_scale), ``thresh``/``rise``/``fall`` features blend
their color in where the quantity crosses a threshold between a sample and
the next valid sample farther out.

The JAX package scans the stored samples far end first. Here the samples
come camera first, as the scan route's loop makes them, and nothing is
stored per step: a sample's update of a channel is an affine map
chan -> a chan + b (a a scalar per ray and image), so the stream keeps
the composition of the maps met so far, (A, B), and the image is B at the
end. A sample's map needs the cells of the next valid sample farther out,
so each ray holds its last valid sample (cells and path length) until the
next one comes, or until the end, where that cell value is NaN. Invalid
samples (dead rays, dp's rejected attempts) are skipped, as the JAX
package's ``compact_samples`` drops them.

``Renderer`` is the per-sample update; ``transfer/unpolarized.
integrate_unpolarized`` runs it beside the image planes on the same trace
and the same cell values. ``integrate_rendering`` runs it alone.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from blacklight_tpu_torch.constants import NUM_CELL_VALUES, RenderType
from blacklight_tpu_torch.ops import geodesic
from blacklight_tpu_torch.transfer import unpolarized as tu

DELTA_TAU_MAX = 100.0  # reference radiation_integrator.hpp:191


class Renderer:
    """The streamed renderings of ``render_images`` (RenderImage configs,
    utils.config) for a ray bundle. Its per-ray tensors live in the scan
    route's carry (``start``), so they follow the rays when the bundle
    drops finished ones."""

    def __init__(self, render_images: Sequence, mass_msun: float,
                 params: geodesic.GeodesicParams):
        self.images = tuple(render_images)
        self.x_cm = tu.x_unit(mass_msun)
        self.params = params
        self.fill = any(feat.render_type == RenderType.fill
                        for img in self.images for feat in img.features)
        self._colors = {}

    def colors(self, dtype, device) -> list:
        """Each image's feature colors as (3,) tensors, made once per
        dtype and device (a step captured in a CUDA graph copies nothing
        from the host)."""
        key = (dtype, device)
        if key not in self._colors:
            self._colors[key] = [
                [torch.tensor([f.x_val, f.y_val, f.z_val], dtype=dtype,
                              device=device) for f in img.features]
                for img in self.images]
        return self._colors[key]

    def start(self, b: int, dtype, device) -> dict:
        """The per-ray tensors before the first sample: the composed map
        (A (B, n_images), B (B, n_images, 3)) and the held sample."""
        n = len(self.images)
        return {
            "render_a": torch.ones((b, n), dtype=dtype, device=device),
            "render_b": torch.zeros((b, n, 3), dtype=dtype, device=device),
            "render_cells": torch.full((b, NUM_CELL_VALUES), math.nan,
                                       dtype=dtype, device=device),
            "render_length": torch.zeros((b,), dtype=dtype, device=device),
            "render_held": torch.zeros((b,), dtype=torch.bool,
                                       device=device),
        }

    def delta_length(self, valid, pos, kcov, h):
        """(B,) the proper length of each sample's step in cm, as the JAX
        package forms it (rendering.py:67-73): no floor under dl2, where
        the length plane's proper_length floors it at 1e-300; zero without
        a fill feature."""
        if not self.fill:
            return torch.zeros_like(h)
        p = self.params
        dl2 = tu.proper_length(pos, kcov, p.bh_a, p.bh_m, p.ray_flat)
        return torch.sqrt(torch.maximum(dl2, torch.zeros_like(dl2))) \
            * -torch.where(valid, h, 0.0) * self.x_cm

    def _compose(self, st, cells, length, prev, close):
        """Fold the held samples' maps (``cells``, ``length``, the next
        valid sample's ``prev`` cells) into (A, B) where ``close``."""
        a_all, b_all = st["render_a"], st["render_b"]
        a_cols, b_cols = [], []
        colors = self.colors(a_all.dtype, a_all.device)
        for n_i, img in enumerate(self.images):
            a, b = a_all[:, n_i], b_all[:, n_i, :]
            # the sample's map applies its features in config order, so
            # they fold onto the nearer samples' map last to first
            for feat, color in zip(reversed(img.features),
                                   reversed(colors[n_i])):
                cur = cells[:, feat.quantity]
                if feat.render_type == RenderType.fill:
                    hit = close & (cur >= feat.min_val) \
                        & (cur <= feat.max_val)
                    delta_tau = length / feat.tau_scale
                    thin = delta_tau <= DELTA_TAU_MAX
                    exp_neg = torch.exp(-delta_tau)
                    gain = exp_neg[:, None] * (color[None, :]
                                               * torch.expm1(delta_tau)[:, None])
                    fa = torch.where(thin, exp_neg, 0.0)
                    fb = torch.where(thin[:, None], gain, color[None, :])
                else:
                    old = prev[:, feat.quantity]
                    hit = torch.zeros_like(close)
                    if feat.render_type in (RenderType.thresh,
                                            RenderType.rise):
                        hit = hit | ((old < feat.thresh_val)
                                     & (cur >= feat.thresh_val))
                    if feat.render_type in (RenderType.thresh,
                                            RenderType.fall):
                        hit = hit | ((old > feat.thresh_val)
                                     & (cur <= feat.thresh_val))
                    hit = hit & close
                    fa = torch.full_like(cur, 1.0 - feat.opacity)
                    fb = (feat.opacity * color)[None, :].expand(b.shape)
                b = torch.where(hit[:, None], a[:, None] * fb + b, b)
                a = torch.where(hit, a * fa, a)
            a_cols.append(a)
            b_cols.append(b)
        st["render_a"] = torch.stack(a_cols, dim=1)
        st["render_b"] = torch.stack(b_cols, dim=1)

    def update(self, st: dict, valid, cells, length) -> None:
        """One step's samples: ``cells`` (B, NUM_CELL_VALUES) with NaN
        where unset, ``length`` their ``delta_length``; replaces the
        per-ray tensors in ``st``."""
        self._compose(st, st["render_cells"], st["render_length"], cells,
                      valid & st["render_held"])
        st["render_cells"] = torch.where(valid[:, None], cells,
                                         st["render_cells"])
        st["render_length"] = torch.where(valid, length,
                                          st["render_length"])
        st["render_held"] = st["render_held"] | valid

    def finish(self, st: dict):
        """(B, n_images, 3) XYZ: the held samples closed with no valid
        sample farther out (NaN cells)."""
        prev = torch.full_like(st["render_cells"], math.nan)
        self._compose(st, st["render_cells"], st["render_length"], prev,
                      st["render_held"])
        return st["render_b"]


def integrate_rendering(positions, directions, params: geodesic.GeodesicParams,
                        cell_fn: Callable, render_images: Sequence,
                        mass_msun: float, camera_x):
    """Render false-color images over a pixel bundle on its own trace
    (the polarized route's renderings; the unpolarized one renders beside
    its planes).

    cell_fn(pos (B, 4), kcov four (B,) components) -> (B, NUM_CELL_VALUES)
    cell values, NaN where unset; camera_x four Python floats (where
    invalid samples are evaluated).

    Returns ((B, n_images, 3) XYZ, flags (B,) bool, n_samples (B,) int32).
    """
    # no image plane: the trace forms no coefficients
    out = tu.integrate_unpolarized(
        positions, directions, torch.ones_like(positions[:, 0]),
        torch.ones(1, dtype=positions.dtype, device=positions.device),
        params=params, integrator=params.integrator.value,
        coeff_fn=None, opts=tu.ImageOptions(light=False),
        mass_msun=mass_msun, camera_x=camera_x, cell_fn=cell_fn,
        render=Renderer(render_images, mass_msun, params))
    return out["rendering"], out["_flags"], out["_n_samples"]
