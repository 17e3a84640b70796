"""Analytic power-law disk emission model of 2020 ApJ 897 148.

Port of ``blacklight_tpu/models/formula.py`` (parameters,
``formula_log_j_scale``) and of the componentwise coefficient forms the
fused kernel uses (``blacklight_tpu/ops/pallas_formula.py:52-186``):
spatial cuts, disk four-velocity, Gaussian density profile, and the
invariant j (in units of cn0/nup^2) and alpha at one frequency.

The kernel forms differ from the JAX package's batched
``formula_coefficients`` in two places, and the component forms follow
the kernel: sin/cos of phi come in closed form rather than through atan2,
and ``pow`` of a zero base with a negative integer exponent gives 0 where
the batched form flags the sample bad. The batched forms
(``formula_coefficients``, ``cpp_pow``; formula.py:58-224) are ported as
well, for the transfer route of the auxiliary image planes
(``transfer/unpolarized.integrate_unpolarized``), which the JAX package's
formula ``run`` takes.

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
                   camera_x, r0=None, h=None):
    """Frequency-independent part of the coefficients: cut mask, bad mask
    (non-timelike disk velocity), n/n0 and u.k (formula_coefficients.cpp
    :74-162, kernel form), and r and cos(theta), from which the tangent
    weights of the density profile follow. camera_x is a 4-tuple of Python
    floats. r0 and h, where given (0-dim tensors in the rays' dtype),
    replace fp's in the density profile; absent, the profile keeps its
    float64 host constants."""
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

    radial = (r * r * (1.0 / (fp.r0 * fp.r0)) if r0 is None
              else r * r / (r0 * r0))
    h_sq = fp.h * fp.h if h is None else h * h
    n_n0 = torch.exp(-0.5 * (radial + h_sq * cth * cth))
    u_dot_k = u0 * k0 + u1 * k1 + u2 * k2 + u3 * k3
    return keep, bad, n_n0, u_dot_k, r, cth


def formula_jalpha_c(keep, bad, n_n0, u_dot_k, mom, nu: float,
                     fp: FormulaParams, cn0=None, with_unit=False):
    """Invariant j (scaled by nup^2/cn0) and alpha at frequency nu from
    the shared geometry (formula_coefficients.cpp:164-179), with C++
    ``pow`` semantics for a negative base. Returns (j, alpha, bad), j and
    alpha zeroed where cut. cn0, where given (a 0-dim tensor), replaces
    fp.cn0 in alpha; with_unit appends alpha_unit = d alpha / d cn0 (alpha
    is linear in cn0), zeroed where cut like alpha."""
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
    alpha_unit = fp.a_param * n_n0 * pa * nu_fluid
    alpha = (fp.cn0 if cn0 is None else cn0) * alpha_unit
    out = (torch.where(keep, j, 0.0), torch.where(keep, alpha, 0.0),
           bad & keep)
    if with_unit:
        return out + (torch.where(keep, alpha_unit, 0.0),)
    return out


def formula_coefficients(pos, kcov, momentum_factors, frequencies,
                         params: FormulaParams, camera_x):
    """Invariant j (in units of cn0/nup^2) and alpha of a batch of
    samples: the JAX package's batched form (formula.py:58-192).

    pos, kcov: (B, 4) CKS positions and covariant momenta;
    momentum_factors (B,); frequencies (F,); camera_x a 4-sequence of
    Python floats.

    Returns (j, alpha, keep, bad): j and alpha (B, F), zero where cut;
    keep (B,) the sample mask after the cuts; bad (B, F) where the C++
    computation gives NaN (``cpp_pow`` of a negative base with a
    non-integer exponent or of zero with a negative one, a non-timelike
    disk velocity), with finite placeholders in j and alpha there.
    """
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    bh_m, bh_a = params.bh_m, params.bh_a
    r = radius_c(x, y, z, bh_a)

    # cuts (formula_coefficients.cpp:73-116)
    keep = r <= params.camera_r
    if params.cut_omit_near or params.cut_omit_far:
        dot = x * camera_x[1] + y * camera_x[2] + z * camera_x[3]
        if params.cut_omit_near:
            keep = keep & ~(dot > 0.0)
        if params.cut_omit_far:
            keep = keep & ~(dot < 0.0)
    if params.cut_omit_in >= 0.0:
        keep = keep & ~(r < params.cut_omit_in)
    if params.cut_omit_out >= 0.0:
        keep = keep & ~(r > params.cut_omit_out)
    if params.cut_midplane_theta != 0.0:
        off = torch.abs(torch.arccos(z / r) - math.pi / 2.0)
        if params.cut_midplane_theta > 0.0:
            keep = keep & ~(off > params.cut_midplane_theta)
        else:
            keep = keep & ~(off < -params.cut_midplane_theta)
    if params.cut_midplane_z != 0.0:
        if params.cut_midplane_z > 0.0:
            keep = keep & ~(torch.abs(z) > params.cut_midplane_z)
        else:
            keep = keep & ~(torch.abs(z) < -params.cut_midplane_z)
    if params.cut_plane:
        ox, oy, oz = params.cut_plane_origin
        nx, ny, nz = params.cut_plane_normal
        keep = keep & ~((x - ox) * nx + (y - oy) * ny + (z - oz) * nz < 0.0)

    # Boyer-Lindquist-like coordinates and metric (cpp:118-133)
    rr = torch.sqrt(torch.clamp(r * r - z * z, min=1e-300))
    cth = z / r
    sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
    ph = torch.atan2(y, x) - torch.atan(bh_a / r)
    sph = torch.sin(ph)
    cph = torch.cos(ph)
    delta = r * r - 2.0 * bh_m * r + bh_a * bh_a
    sigma = r * r + bh_a * bh_a * cth * cth
    gtt_bl = -(1.0 + 2.0 * bh_m * r * (r * r + bh_a * bh_a)
               / (delta * sigma))
    gtph_bl = -2.0 * bh_m * bh_a * r / (delta * sigma)
    grr_bl = delta / sigma
    gthth_bl = 1.0 / sigma
    gphph_bl = (sigma - 2.0 * bh_m * r) / (delta * sigma * sth * sth)

    # ell(r) and the four-velocity (C 6-8; cpp:135-157); a non-timelike
    # profile (C++ sqrt of a negative) is a finite placeholder and bad
    ll = params.l0 / (1.0 + rr) * torch.pow(rr, 1.0 + params.q)
    u_arg = -gtt_bl + 2.0 * gtph_bl * ll - gphph_bl * ll * ll
    bad = ~(u_arg > 0.0)
    u_norm = 1.0 / torch.sqrt(torch.where(u_arg > 0.0, u_arg, 1.0))
    u_t_bl = -u_norm
    u_ph_bl = u_norm * ll
    ut_bl = gtt_bl * u_t_bl + gtph_bl * u_ph_bl
    ur_bl = grr_bl * 0.0
    uth_bl = gthth_bl * 0.0
    uph_bl = gtph_bl * u_t_bl + gphph_bl * u_ph_bl
    ut = ut_bl + 2.0 * bh_m * r / delta * ur_bl
    ur = ur_bl
    uth = uth_bl
    uph = uph_bl + bh_a / delta * ur_bl
    u0 = ut
    u1 = (sth * cph * ur + cth * (r * cph - bh_a * sph) * uth
          + sth * (-r * sph - bh_a * cph) * uph)
    u2 = (sth * sph * ur + cth * (r * sph + bh_a * cph) * uth
          + sth * (r * cph - bh_a * sph) * uph)
    u3 = cth * ur - r * sth * uth

    # density profile and coefficients (C 5, 9-12; cpp:159-179)
    n_n0 = torch.exp(-0.5 * (r * r / (params.r0 * params.r0)
                             + params.h * params.h * cth * cth))
    u_dot_k = (u0 * kcov[..., 0] + u1 * kcov[..., 1]
               + u2 * kcov[..., 2] + u3 * kcov[..., 3])
    nu_fluid = -u_dot_k[..., None] * frequencies[None, :] \
        * momentum_factors[..., None]
    x_raw = nu_fluid / params.nup
    pow_j, bad_j = cpp_pow(x_raw, -params.alpha - 2.0)
    pow_a, bad_a = cpp_pow(x_raw, -params.beta - params.alpha)
    j_scaled = n_n0[..., None] * pow_j
    alpha_fluid = params.a_param * params.cn0 * n_n0[..., None] * pow_a
    alpha_invariant = alpha_fluid * nu_fluid
    keep = keep[..., None].expand(j_scaled.shape)
    # a bad j poisons the pixel; a bad alpha alone routes to the j-only
    # branch (the reference's alpha > 0 test is false for NaN), as zero
    bad = (bad[..., None] | bad_j) & keep
    alpha_invariant = torch.where(bad_a, 0.0, alpha_invariant)
    return (torch.where(keep, j_scaled, 0.0),
            torch.where(keep, alpha_invariant, 0.0), keep[..., 0], bad)


def cpp_pow(x, e: float):
    """C++ ``std::pow`` of a possibly negative base by a constant exponent
    e, without a NaN or inf primal (formula.py:195-224).

    Returns (value, bad): value is finite, |x|^e with C++'s sign for an
    integer e; bad marks where C++ gives NaN (a negative base with a
    non-integer e) or, for e < 0, a zero base (inf, flagged rather than
    formed).
    """
    x_safe = torch.where(x > 0.0, x, 1.0)
    pos = torch.pow(x_safe, e)
    xn_safe = torch.where(x < 0.0, -x, 1.0)
    integer, sign = cpp_pow_exponent(e)
    bad = torch.zeros_like(x, dtype=torch.bool) if integer else x < 0.0
    neg = sign * torch.pow(xn_safe, e)
    zero = torch.pow(torch.where(x == 0.0, x, 1.0), e)
    if e < 0.0:
        bad = bad | (x == 0.0)
        zero = torch.where(x == 0.0, 1.0, zero)
    return torch.where(x > 0.0, pos, torch.where(x < 0.0, neg, zero)), bad
