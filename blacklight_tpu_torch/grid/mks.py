"""Modified Kerr-Schild (MKS) and Funky MKS (FMKS) coordinate support.

Port of ``blacklight_tpu/grid/mks.py``: the host-side (numpy) geometry
of the reference's simulation reader (src/simulation_reader/
simulation_geometry.cpp): the grid-coordinate transformation MKS -> SKS
(ConvertCoordinates, :29-82), normal-frame 3-vector primitives -> SKS
normal frame (ConvertPrimitives3, :95-229), harm3d coordinate-frame
4-vectors -> SKS normal frame (ConvertPrimitives4, :242-317), the FMKS
theta formula (GetSKSCoordinates, :416-431), the Jacobian factors
(SetJacobianFactors, :440-471), and the inverse SKS -> FMKS lookup table
(GenerateSKSMap, :330-407). The numpy functions are the JAX package's,
line for line, so that a loaded snapshot's primitives are its bits; the
table's bisection runs in torch on the grid's device (60 rounds over
2048^2 points in float64), where the JAX package runs it in numpy on the
host: each round's comparison may differ by an ulp of theta between the
two, which moves the answer by no more than that ulp's width in x^2.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Map resolution/tolerances mirror the reference (simulation_reader.hpp:109-112)
SKS_MAP_N1 = 2048
SKS_MAP_N2 = 2048
SKS_MAP_MAX_ITER = 1000
SKS_MAP_TOL = 1.0e-8

# Fractional-cell tolerance for snapping angular domains (simulation_reader.hpp:100)
ANGULAR_DOMAIN_TOLERANCE = 0.1


@dataclasses.dataclass(frozen=True)
class FmksParams:
    """FMKS (MMKS) metric parameters from an iharm3d header
    (simulation_reader.cpp:364-431)."""

    h: float
    r_in: float
    poly_xt: float
    poly_alpha: float
    mks_smooth: float

    @property
    def poly_norm(self) -> float:
        n = (self.poly_alpha + 1.0) * self.poly_xt ** self.poly_alpha
        return 0.5 * np.pi * n / (n + 1.0)


def mks_theta(x2, h):
    """theta(x^2) for regular MKS (simulation_geometry.cpp:77-81)."""
    x2 = np.asarray(x2)
    return np.pi * x2 + (1.0 - h) / 2.0 * np.sin(2.0 * np.pi * x2)


def fmks_sks_coords(x1, x2, p: FmksParams):
    """(r, theta) at native FMKS (x^1, x^2) (simulation_geometry.cpp:416-431)."""
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    r = np.exp(x1)
    y = 2.0 * x2 - 1.0
    theta_g = mks_theta(x2, p.h)
    # pow(y/xt, alpha) with alpha an even integer (FMKS convention; 14 in
    # iharm) is even-symmetric: |y/xt|^alpha. C++ pow of a negative base
    # with non-integer alpha would be NaN, so even symmetry is the only
    # well-defined reading.
    frac = np.abs(y / p.poly_xt) ** p.poly_alpha
    theta_j = 0.5 * np.pi + p.poly_norm * y * (1.0 + frac / (p.poly_alpha + 1.0))
    theta = theta_g + np.exp(p.mks_smooth * (np.log(p.r_in) - x1)) * (theta_j - theta_g)
    return r, theta


def jacobian_factors(x1, x2, coord: str, p):
    """(dr/dx1, dth/dx1, dth/dx2) at native (x^1, x^2)
    (simulation_geometry.cpp:440-471).

    coord: "fmks" (p: FmksParams) or "mks" (p: float hslope).
    """
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    dr_dx1 = np.exp(x1)
    if coord == "fmks":
        h = p.h
        var_a = np.exp(p.mks_smooth * (np.log(p.r_in) - x1))
        var_b = np.pi * (0.5 - x2)
        y = 2.0 * x2 - 1.0
        var_c = np.abs(y / p.poly_xt) ** p.poly_alpha
        var_d = 1.0 + p.poly_alpha
        var_e = p.poly_norm * (1.0 + var_c / var_d)
        var_f = var_e * y
        var_g = -0.5 * (1.0 - h) * np.sin(2.0 * np.pi * x2)
        dth_dx1 = -p.mks_smooth * var_a * (var_b + var_f + var_g)
        var_h = np.pi + (1.0 - h) * np.pi * np.cos(2.0 * np.pi * x2)
        var_i = -np.pi + 2.0 * var_e
        var_j = 2.0 * p.poly_norm * p.poly_alpha * var_c / var_d
        var_k = -(1.0 - h) * np.pi * np.cos(2.0 * np.pi * x2)
        dth_dx2 = var_h + var_a * (var_i + var_j + var_k)
    else:
        h = p
        dth_dx1 = np.zeros_like(x1 + x2)
        dth_dx2 = np.pi + (1.0 - h) * np.pi * np.cos(2.0 * np.pi * x2)
    return dr_dx1, dth_dx1, dth_dx2


def _fmks_theta(x1, x2, p: FmksParams):
    """theta of fmks_sks_coords on float64 tensors (its forms)."""
    y = 2.0 * x2 - 1.0
    theta_g = math.pi * x2 + (1.0 - p.h) / 2.0 * torch.sin(2.0 * math.pi * x2)
    frac = torch.abs(y / p.poly_xt) ** p.poly_alpha
    theta_j = 0.5 * math.pi + p.poly_norm * y * (1.0 + frac
                                                 / (p.poly_alpha + 1.0))
    return theta_g + torch.exp(p.mks_smooth * (math.log(p.r_in) - x1)) \
        * (theta_j - theta_g)


def generate_sks_map(p: FmksParams, r_in: float, r_out: float,
                     n1: int = SKS_MAP_N1, n2: int = SKS_MAP_N2, *,
                     device="cpu"):
    """Inverse map SKS (r, theta) -> FMKS (x^1, x^2) on a uniform table.

    Bisection over the whole (n2, n1) table at once on ``device``, in
    float64 (the reference iterates point by point,
    simulation_geometry.cpp:330-407). theta(x1, x2) is monotone in x2 for
    valid FMKS parameters.

    Returns (sks_map (2, n2, n1) float64 tensor on ``device``, dr,
    dtheta).
    """
    dr = (r_out - r_in) / (n1 - 1)
    dtheta = np.pi / (n2 - 1)
    f64 = dict(dtype=torch.float64, device=device)
    # the abscissae in numpy, as the JAX package forms them
    x1 = torch.as_tensor(np.log(r_in + dr * np.arange(n1)), **f64)
    theta_target = torch.as_tensor(
        np.minimum(dtheta * np.arange(n2), np.pi), **f64)

    x1_grid = x1[None, :].expand(n2, n1)
    theta_grid = theta_target[:, None].expand(n2, n1)
    lo = torch.zeros((n2, n1), **f64)
    hi = torch.ones((n2, n1), **f64)
    for _ in range(60):  # bisection: 2^-60 << SKS_MAP_TOL
        mid = 0.5 * (lo + hi)
        take_hi = _fmks_theta(x1_grid, mid, p) < theta_grid
        lo = torch.where(take_hi, mid, lo)
        hi = torch.where(take_hi, hi, mid)
    x2 = 0.5 * (lo + hi)
    # Poles pinned exactly (reference :388-394)
    x2[theta_target < SKS_MAP_TOL, :] = 0.0
    x2[theta_target > np.pi - SKS_MAP_TOL, :] = 1.0
    return torch.stack([x1_grid, x2]), dr, dtheta


def _sks_ks_metric_pieces(r, th, a):
    """Covariant SKS Kerr-Schild metric components + lapse pieces used by the
    primitive transforms (simulation_geometry.cpp:146-183)."""
    sth = np.sin(th)
    cth = np.cos(th)
    sigma = r * r + a * a * cth * cth
    f = 2.0 * r / sigma
    g = dict(
        g_tr=f, g_tth=0.0, g_tph=-a * f * sth * sth,
        g_rr=1.0 + f, g_rth=0.0, g_rph=-a * (1.0 + f) * sth * sth,
        g_thth=sigma, g_thph=0.0,
        g_phph=(r * r + a * a + a * a * f * sth * sth) * sth * sth,
        gtt=-(1.0 + f), gtr=f, gtth=0.0, gtph=0.0)
    g["alpha"] = 1.0 / np.sqrt(-g["gtt"])
    return g


def convert_primitives_3(prim, ind, x1v_native, x2v_native, x3v, r_v, th_v,
                         a, coord: str, params):
    """Normal-frame 3-velocity + cell-frame B in modified coordinates ->
    SKS normal frame, in place (simulation_geometry.cpp:95-229).

    prim: (nvar, 1, n3, n2, n1) float32; ind: name->slot dict.
    x1v_native/x2v_native: native (modified) cell-center coordinates;
    r_v/th_v: the same points in SKS. coord: "mks" | "fmks";
    params: hslope (mks) or FmksParams (fmks).
    """
    n3 = x3v.shape[0]
    # Broadcast grids: shapes (n3, n2, n1) via (1, n2, n1) except FMKS theta
    x1 = np.asarray(x1v_native, dtype=np.float64)[None, None, :]
    x2 = np.asarray(x2v_native, dtype=np.float64)[None, :, None]
    r = np.asarray(r_v, dtype=np.float64)
    th = np.asarray(th_v, dtype=np.float64)
    if r.ndim == 1:
        r = r[None, None, :]
    if th.ndim == 1:
        th = th[None, :, None]

    dr_dx1, dth_dx1, dth_dx2 = jacobian_factors(x1, x2, coord, params)

    m = _sks_ks_metric_pieces(r, th, a)
    # Modified (native-coordinate) metric via the Jacobian
    g_01 = dr_dx1 * m["g_tr"] + dth_dx1 * m["g_tth"]
    g_02 = dth_dx2 * m["g_tth"]
    g_03 = m["g_tph"]
    g_11 = (dr_dx1 * dr_dx1 * m["g_rr"] + 2.0 * dr_dx1 * dth_dx1 * m["g_rth"]
            + dth_dx1 * dth_dx1 * m["g_thth"])
    g_12 = dr_dx1 * dth_dx2 * m["g_rth"] + dth_dx1 * dth_dx2 * m["g_thth"]
    g_13 = dr_dx1 * m["g_rph"] + dth_dx1 * m["g_thph"]
    g_22 = dth_dx2 * dth_dx2 * m["g_thth"]
    g_23 = dth_dx2 * m["g_thph"]
    g_33 = m["g_phph"]
    g00 = m["gtt"]
    g01 = m["gtr"] / dr_dx1
    g02 = m["g_tth"] / dth_dx2 - dth_dx1 * m["gtr"] / (dr_dx1 * dth_dx2)
    g03 = m["gtph"]
    alpha = m["alpha"]
    alpha_mod = 1.0 / np.sqrt(-g00)

    uu1 = np.asarray(prim[ind["uu1"], 0], dtype=np.float64)
    uu2 = np.asarray(prim[ind["uu2"], 0], dtype=np.float64)
    uu3 = np.asarray(prim[ind["uu3"], 0], dtype=np.float64)
    bb1 = np.asarray(prim[ind["bb1"], 0], dtype=np.float64)
    bb2 = np.asarray(prim[ind["bb2"], 0], dtype=np.float64)
    bb3 = np.asarray(prim[ind["bb3"], 0], dtype=np.float64)
    del n3

    # Modified normal frame -> modified coordinate frame
    uu0 = np.sqrt(1.0 + g_11 * uu1 * uu1 + 2.0 * g_12 * uu1 * uu2
                  + 2.0 * g_13 * uu1 * uu3 + g_22 * uu2 * uu2
                  + 2.0 * g_23 * uu2 * uu3 + g_33 * uu3 * uu3)
    u0 = uu0 / alpha_mod
    u1 = uu1 - alpha_mod * g01 * uu0
    u2 = uu2 - alpha_mod * g02 * uu0
    u3 = uu3 - alpha_mod * g03 * uu0
    u_1 = g_01 * u0 + g_11 * u1 + g_12 * u2 + g_13 * u3
    u_2 = g_02 * u0 + g_12 * u1 + g_22 * u2 + g_23 * u3
    u_3 = g_03 * u0 + g_13 * u1 + g_23 * u2 + g_33 * u3

    # Modified coordinate frame -> standard coordinate frame
    ut = u0
    ur = dr_dx1 * u1
    uth = dth_dx1 * u1 + dth_dx2 * u2
    uph = u3

    # Standard coordinate frame -> standard normal frame
    uur = ur + alpha * alpha * m["gtr"] * ut
    uuth = uth + alpha * alpha * m["gtth"] * ut
    uuph = uph + alpha * alpha * m["gtph"] * ut

    # Magnetic 4-vector in modified coordinate frame
    b0 = u_1 * bb1 + u_2 * bb2 + u_3 * bb3
    b1 = (bb1 + b0 * u1) / u0
    b2 = (bb2 + b0 * u2) / u0
    b3 = (bb3 + b0 * u3) / u0

    bt = b0
    br = dr_dx1 * b1
    bth = dth_dx1 * b1 + dth_dx2 * b2
    bph = b3

    bbr = br * ut - bt * ur
    bbth = bth * ut - bt * uth
    bbph = bph * ut - bt * uph

    prim[ind["uu1"], 0] = uur.astype(np.float32)
    prim[ind["uu2"], 0] = uuth.astype(np.float32)
    prim[ind["uu3"], 0] = uuph.astype(np.float32)
    prim[ind["bb1"], 0] = bbr.astype(np.float32)
    prim[ind["bb2"], 0] = bbth.astype(np.float32)
    prim[ind["bb3"], 0] = bbph.astype(np.float32)


def convert_primitives_4(prim, ind, x2v_native, r_v, th_v, a, h):
    """harm3d coordinate-frame 4-vectors u^mu/b^mu in MKS -> SKS normal
    frame, in place (simulation_geometry.cpp:242-317).

    prim slots used: u0/uu1..3 hold u^mu, b0/bb1..3 hold b^mu on input;
    uu1..3/bb1..3 are overwritten with SKS normal-frame values.
    """
    x2 = np.asarray(x2v_native, dtype=np.float64)[None, :, None]
    r = np.asarray(r_v, dtype=np.float64)[None, None, :]
    th = np.asarray(th_v, dtype=np.float64)[None, :, None]
    cth = np.cos(th)

    u0 = np.asarray(prim[ind["u0"], 0], dtype=np.float64)
    u1 = np.asarray(prim[ind["uu1"], 0], dtype=np.float64)
    u2 = np.asarray(prim[ind["uu2"], 0], dtype=np.float64)
    u3 = np.asarray(prim[ind["uu3"], 0], dtype=np.float64)
    b0 = np.asarray(prim[ind["b0"], 0], dtype=np.float64)
    b1 = np.asarray(prim[ind["bb1"], 0], dtype=np.float64)
    b2 = np.asarray(prim[ind["bb2"], 0], dtype=np.float64)
    b3 = np.asarray(prim[ind["bb3"], 0], dtype=np.float64)

    dr_dx1 = r
    dth_dx2 = np.pi + (1.0 - h) * np.pi * np.cos(2.0 * np.pi * x2)

    sigma = r * r + a * a * cth * cth
    f = 2.0 * r / sigma
    gtt = -(1.0 + f)
    gtr = f
    alpha = 1.0 / np.sqrt(-gtt)

    ut = u0
    ur = dr_dx1 * u1
    uth = dth_dx2 * u2
    uph = u3

    uur = ur + alpha * alpha * gtr * ut
    uuth = uth
    uuph = uph

    bt = b0
    br = dr_dx1 * b1
    bth = dth_dx2 * b2
    bph = b3

    bbr = br * ut - bt * ur
    bbth = bth * ut - bt * uth
    bbph = bph * ut - bt * uph

    prim[ind["uu1"], 0] = uur.astype(np.float32)
    prim[ind["uu2"], 0] = uuth.astype(np.float32)
    prim[ind["uu3"], 0] = uuph.astype(np.float32)
    prim[ind["bb1"], 0] = bbr.astype(np.float32)
    prim[ind["bb2"], 0] = bbth.astype(np.float32)
    prim[ind["bb3"], 0] = bbph.astype(np.float32)


def snap_angular_domain(x2f, x3f, warn, snap_theta=True):
    """Force theta/phi face ranges to [0, pi]/[0, 2pi] when the file's
    endpoints deviate by more than a tolerance fraction of an edge cell,
    with warnings (simulation_reader.cpp:721-758). x2f/x3f: (n+1,) arrays,
    modified in place; warn: callable(str)."""
    if snap_theta and (
            abs(x2f[0]) > (x2f[1] - x2f[0]) * ANGULAR_DOMAIN_TOLERANCE
            or abs(x2f[-1] - np.pi)
            > (x2f[-1] - x2f[-2]) * ANGULAR_DOMAIN_TOLERANCE):
        warn(f"Changing theta range from [{x2f[0]:.16e}, {x2f[-1]:.16e}] to [0, pi].")
        x2f[0] = 0.0
        x2f[-1] = np.pi
    two_pi = 2.0 * np.pi
    if (abs(x3f[0]) > (x3f[1] - x3f[0]) * ANGULAR_DOMAIN_TOLERANCE
            or abs(x3f[-1] - two_pi)
            > (x3f[-1] - x3f[-2]) * ANGULAR_DOMAIN_TOLERANCE):
        warn(f"Changing phi range from [{x3f[0]:.16e}, {x3f[-1]:.16e}] to [0, 2*pi].")
        x3f[0] = 0.0
        x3f[-1] = two_pi
