"""Geometric sample cuts shared by all models.

Port of ``blacklight_tpu/models/cuts.py`` (:18-81): camera radius,
near/far half-space, spheres, midplane slab and an arbitrary plane, as
the reference applies them during sampling
(simulation_sampling.cpp:238-295).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from blacklight_tpu_torch.ops.geometry import radius_c


@dataclasses.dataclass(frozen=True)
class GeometricCuts:
    camera_r: float
    omit_near: bool = False
    omit_far: bool = False
    omit_in: float = -1.0
    omit_out: float = -1.0
    midplane_theta: float = 0.0
    midplane_z: float = 0.0
    plane: bool = False
    plane_origin: tuple = (0.0, 0.0, 0.0)
    plane_normal: tuple = (0.0, 0.0, 1.0)

    @staticmethod
    def from_config(cfg) -> "GeometricCuts":
        return GeometricCuts(
            camera_r=cfg.require("camera_r"),
            omit_near=cfg.require("cut_omit_near"),
            omit_far=cfg.require("cut_omit_far"),
            omit_in=cfg.require("cut_omit_in"),
            omit_out=cfg.require("cut_omit_out"),
            midplane_theta=cfg.require("cut_midplane_theta"),
            midplane_z=cfg.require("cut_midplane_z"),
            plane=cfg.require("cut_plane"),
            plane_origin=(cfg.cut_plane_origin_x or 0.0,
                          cfg.cut_plane_origin_y or 0.0,
                          cfg.cut_plane_origin_z or 0.0),
            plane_normal=(cfg.cut_plane_normal_x or 0.0,
                          cfg.cut_plane_normal_y or 0.0,
                          cfg.cut_plane_normal_z or 0.0))


def geometric_keep(pos, spin, camera_x, cuts: GeometricCuts):
    """(B,) True where the sample at CKS ``pos`` (B, 4) survives every
    geometric cut; ``camera_x`` is the camera position (4 floats)."""
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    r = radius_c(x, y, z, spin)
    keep = r <= cuts.camera_r
    if cuts.omit_near or cuts.omit_far:
        dot = x * camera_x[1] + y * camera_x[2] + z * camera_x[3]
        if cuts.omit_near:
            keep &= ~(dot > 0.0)
        if cuts.omit_far:
            keep &= ~(dot < 0.0)
    if cuts.omit_in >= 0.0:
        keep &= ~(r < cuts.omit_in)
    if cuts.omit_out >= 0.0:
        keep &= ~(r > cuts.omit_out)
    if cuts.midplane_theta != 0.0:
        off = torch.abs(torch.arccos(z / r) - math.pi / 2.0)
        if cuts.midplane_theta > 0.0:
            keep &= ~(off > cuts.midplane_theta)
        else:
            keep &= ~(off < -cuts.midplane_theta)
    if cuts.midplane_z != 0.0:
        if cuts.midplane_z > 0.0:
            keep &= ~(torch.abs(z) > cuts.midplane_z)
        else:
            keep &= ~(torch.abs(z) < -cuts.midplane_z)
    if cuts.plane:
        ox, oy, oz = cuts.plane_origin
        nx, ny, nz = cuts.plane_normal
        dot = (x - ox) * nx + (y - oy) * ny + (z - oz) * nz
        keep &= ~(dot < 0.0)
    return keep


# Names of the geometric-cut block of a fused kernel's float64 parameter
# vector, in the order of the enum CutParam in csrc/cuts.cuh.
CUT_PARAM_NAMES = (
    "CUT_NEAR", "CUT_FAR", "CUT_IN_ON", "CUT_IN", "CUT_OUT_ON", "CUT_OUT",
    "CUT_MID_THETA_SIGN", "CUT_MID_THETA", "CUT_MID_Z_SIGN", "CUT_MID_Z",
    "CUT_PLANE", "PLANE_OX", "PLANE_OY", "PLANE_OZ", "PLANE_NX", "PLANE_NY",
    "PLANE_NZ",
)


def _sign(v: float) -> float:
    return 1.0 if v > 0.0 else (-1.0 if v < 0.0 else 0.0)


def cut_param_values(cuts: GeometricCuts) -> dict:
    """The geometric-cut block of a fused kernel's float64 parameter
    vector by CUT_PARAM_NAMES (csrc/cuts.cuh CutConsts): an _ON flag or a
    sign (-1, 0, +1) decided here from the float64 value, then the value
    (a magnitude for the signs). The camera-radius cut is not in the
    block: each kernel passes its own camera radius."""
    return {
        "CUT_NEAR": cuts.omit_near, "CUT_FAR": cuts.omit_far,
        "CUT_IN_ON": cuts.omit_in >= 0.0, "CUT_IN": cuts.omit_in,
        "CUT_OUT_ON": cuts.omit_out >= 0.0, "CUT_OUT": cuts.omit_out,
        "CUT_MID_THETA_SIGN": _sign(cuts.midplane_theta),
        "CUT_MID_THETA": abs(cuts.midplane_theta),
        "CUT_MID_Z_SIGN": _sign(cuts.midplane_z),
        "CUT_MID_Z": abs(cuts.midplane_z),
        "CUT_PLANE": cuts.plane,
        "PLANE_OX": cuts.plane_origin[0], "PLANE_OY": cuts.plane_origin[1],
        "PLANE_OZ": cuts.plane_origin[2], "PLANE_NX": cuts.plane_normal[0],
        "PLANE_NY": cuts.plane_normal[1], "PLANE_NZ": cuts.plane_normal[2],
    }
