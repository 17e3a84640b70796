"""Analytic power-law disk emission model of 2020 ApJ 897 148.

Port of ``blacklight_tpu/models/formula.py`` (parameters,
``formula_log_j_scale``) and of the componentwise coefficient forms the
fused kernel uses (``blacklight_tpu/ops/pallas_formula.py:52-186``):
spatial cuts, disk four-velocity, Gaussian density profile, and the
invariant j (in units of cn0/nup^2) and alpha at one frequency.

The kernel forms differ from the JAX package's batched
``formula_coefficients`` in two places, and this module follows the
kernel: sin/cos of phi come in closed form rather than through atan2, and
``pow`` of a zero base with a negative integer exponent gives 0 where the
batched form flags the sample bad.

Division by a constant is written as multiplication by its float64
reciprocal and a constant numerator as ``(1.0 / t) * s``: that is how
PyTorch evaluates both, and the CUDA kernel writes the same forms, so the
plain version and the kernel round alike.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from blacklight_tpu_torch.ops.geometry import radius_c


@dataclasses.dataclass(frozen=True)
class FormulaParams:
    """Model and cut parameters (Python scalars)."""

    bh_m: float
    bh_a: float
    camera_r: float
    # Formula model (input_reader.hpp:59-69)
    mass: float
    r0: float
    h: float
    l0: float
    q: float
    nup: float
    cn0: float
    alpha: float
    beta: float
    a_param: float
    # Cuts (only the geometric ones apply to the formula model)
    cut_omit_near: bool = False
    cut_omit_far: bool = False
    cut_omit_in: float = -1.0
    cut_omit_out: float = -1.0
    cut_midplane_theta: float = 0.0
    cut_midplane_z: float = 0.0
    cut_plane: bool = False
    cut_plane_origin: tuple = (0.0, 0.0, 0.0)
    cut_plane_normal: tuple = (0.0, 0.0, 1.0)


def formula_params_from_config(cfg) -> FormulaParams:
    return FormulaParams(
        bh_m=1.0,
        bh_a=cfg.require("formula_spin"),
        camera_r=cfg.require("camera_r"),
        mass=cfg.require("formula_mass"),
        r0=cfg.require("formula_r0"),
        h=cfg.require("formula_h"),
        l0=cfg.require("formula_l0"),
        q=cfg.require("formula_q"),
        nup=cfg.require("formula_nup"),
        cn0=cfg.require("formula_cn0"),
        alpha=cfg.require("formula_alpha"),
        beta=cfg.require("formula_beta"),
        a_param=cfg.require("formula_a"),
        cut_omit_near=cfg.require("cut_omit_near"),
        cut_omit_far=cfg.require("cut_omit_far"),
        cut_omit_in=cfg.require("cut_omit_in"),
        cut_omit_out=cfg.require("cut_omit_out"),
        cut_midplane_theta=cfg.require("cut_midplane_theta"),
        cut_midplane_z=cfg.require("cut_midplane_z"),
        cut_plane=cfg.require("cut_plane"),
        cut_plane_origin=(cfg.cut_plane_origin_x or 0.0,
                          cfg.cut_plane_origin_y or 0.0,
                          cfg.cut_plane_origin_z or 0.0),
        cut_plane_normal=(cfg.cut_plane_normal_x or 0.0,
                          cfg.cut_plane_normal_y or 0.0,
                          cfg.cut_plane_normal_z or 0.0),
    )


def formula_log_j_scale(params: FormulaParams) -> float:
    """log of the factor restoring CGS units of the scaled invariant j,
    as a Python float: cn0/nup^2 ~ 1e-41 underflows float32."""
    return math.log(params.cn0) - 2.0 * math.log(params.nup)


def cpp_pow_exponent(e: float):
    """(is_integer, sign of a negative base) for C++ ``pow`` with a
    constant exponent e (pallas_formula.py:159-175)."""
    if float(e).is_integer():
        return True, (-1.0 if int(e) % 2 else 1.0)
    return False, 1.0


def formula_geom_c(x0, x1, x2, x3, k0, k1, k2, k3, fp: FormulaParams,
                   camera_x):
    """Frequency-independent part of the coefficients: cut mask, bad mask
    (non-timelike disk velocity), n/n0 and u.k (formula_coefficients.cpp
    :74-162, kernel form). camera_x is a 4-tuple of Python floats."""
    bh_a = fp.bh_a
    r = radius_c(x1, x2, x3, bh_a)

    keep = r <= fp.camera_r
    if fp.cut_omit_near or fp.cut_omit_far:
        dot = x1 * camera_x[1] + x2 * camera_x[2] + x3 * camera_x[3]
        if fp.cut_omit_near:
            keep = keep & ~(dot > 0.0)
        if fp.cut_omit_far:
            keep = keep & ~(dot < 0.0)
    if fp.cut_omit_in >= 0.0:
        keep = keep & ~(r < fp.cut_omit_in)
    if fp.cut_omit_out >= 0.0:
        keep = keep & ~(r > fp.cut_omit_out)
    if fp.cut_midplane_theta != 0.0:
        off = torch.abs(torch.arccos(x3 / r) - math.pi / 2.0)
        if fp.cut_midplane_theta > 0.0:
            keep = keep & ~(off > fp.cut_midplane_theta)
        else:
            keep = keep & ~(off < -fp.cut_midplane_theta)
    if fp.cut_midplane_z != 0.0:
        if fp.cut_midplane_z > 0.0:
            keep = keep & ~(torch.abs(x3) > fp.cut_midplane_z)
        else:
            keep = keep & ~(torch.abs(x3) < -fp.cut_midplane_z)
    if fp.cut_plane:
        ox, oy, oz = fp.cut_plane_origin
        nx, ny, nz = fp.cut_plane_normal
        keep = keep & ~((x1 - ox) * nx + (x2 - oy) * ny + (x3 - oz) * nz
                        < 0.0)

    rr = torch.sqrt(torch.clamp(r * r - x3 * x3, min=1e-30))
    cth = x3 / r
    sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
    # sin/cos of ph = atan2(x2, x1) - atan(a/r) in closed form
    rho_s = torch.sqrt(torch.clamp(x1 * x1 + x2 * x2, min=1e-30)) \
        * torch.sqrt(r * r + bh_a * bh_a)
    cph = (x1 * r + x2 * bh_a) / rho_s
    sph = (x2 * r - x1 * bh_a) / rho_s

    delta = r * r - 2.0 * fp.bh_m * r + bh_a * bh_a
    gtt_bl = -(1.0 + 2.0 * fp.bh_m * r * (r * r + bh_a * bh_a)
               / (delta * (r * r + bh_a * bh_a * cth * cth)))
    sigma = r * r + bh_a * bh_a * cth * cth
    gtph_bl = -2.0 * fp.bh_m * bh_a * r / (delta * sigma)
    gphph_bl = (sigma - 2.0 * fp.bh_m * r) / (delta * sigma * sth * sth)

    ll = (1.0 / (1.0 + rr)) * fp.l0 * torch.pow(rr, 1.0 + fp.q)
    u_arg = -gtt_bl + 2.0 * gtph_bl * ll - gphph_bl * ll * ll
    bad = ~(u_arg > 0.0)
    u_norm = 1.0 / torch.sqrt(torch.where(u_arg > 0.0, u_arg, 1.0))
    u_t_bl = -u_norm
    u_ph_bl = u_norm * ll
    ut_bl = gtt_bl * u_t_bl + gtph_bl * u_ph_bl
    uph_bl = gtph_bl * u_t_bl + gphph_bl * u_ph_bl
    u0 = ut_bl
    u1 = sth * (-r * sph - bh_a * cph) * uph_bl
    u2 = sth * (r * cph - bh_a * sph) * uph_bl
    u3 = torch.zeros_like(u0)

    n_n0 = torch.exp(-0.5 * (r * r * (1.0 / (fp.r0 * fp.r0))
                             + fp.h * fp.h * cth * cth))
    u_dot_k = u0 * k0 + u1 * k1 + u2 * k2 + u3 * k3
    return keep, bad, n_n0, u_dot_k


def formula_jalpha_c(keep, bad, n_n0, u_dot_k, mom, nu: float,
                     fp: FormulaParams):
    """Invariant j (scaled by nup^2/cn0) and alpha at frequency nu from
    the shared geometry (formula_coefficients.cpp:164-179), with C++
    ``pow`` semantics for a negative base. Returns (j, alpha, bad), j and
    alpha zeroed where cut."""
    nu_fluid = -u_dot_k * nu * mom
    x_raw = nu_fluid * (1.0 / fp.nup)

    xs = torch.where(x_raw > 0.0, x_raw, 1.0)
    xn = torch.where(x_raw < 0.0, -x_raw, 1.0)
    ej = -fp.alpha - 2.0
    ea = -fp.beta - fp.alpha
    ej_int, sj = cpp_pow_exponent(ej)
    ea_int, sa = cpp_pow_exponent(ea)
    if ej_int:
        pj = torch.where(x_raw > 0.0, torch.pow(xs, ej),
                         torch.where(x_raw < 0.0, sj * torch.pow(xn, ej),
                                     0.0))
    else:
        pj = torch.where(x_raw > 0.0, torch.pow(xs, ej), 0.0)
        bad = bad | (x_raw < 0.0)
    if ea_int:
        pa = torch.where(x_raw > 0.0, torch.pow(xs, ea),
                         torch.where(x_raw < 0.0, sa * torch.pow(xn, ea),
                                     0.0))
    else:
        # NaN alpha routes to the j-only branch like alpha = 0
        pa = torch.where(x_raw > 0.0, torch.pow(xs, ea), 0.0)

    j = n_n0 * pj
    alpha = fp.cn0 * (fp.a_param * n_n0 * pa * nu_fluid)
    return (torch.where(keep, j, 0.0), torch.where(keep, alpha, 0.0),
            bad & keep)
