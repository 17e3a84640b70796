"""Matter coupling of the polarized transfer in the fluid tetrad frame,
per Stokes component.

Port of the component forms of
``blacklight_tpu/transfer/polarized_coupling.py`` (:235-539): one
emission/absorption/Faraday-rotation step on tetrad-frame Stokes
(I, Q, U, V) with j = (j_I, j_Q, 0, j_V), alpha = (alpha_I, alpha_Q, 0,
alpha_V) and rho = (rho_Q, 0, rho_V), in the regimes of the reference's
ladder (polarized.cpp:380-790; Landi Degl'Innocenti & Landi
Degl'Innocenti 1985 for the full matrix). Every regime is evaluated and
the sample's own is selected, as the JAX package's XLA path does; the
floors of ``_lims`` depend on the dtype as there.
"""

from __future__ import annotations

import torch

DELTA_TAU_MAX = 100.0  # unpolarized.cpp:96-110

# sqrt floor, cap on hyperbolic arguments (cosh(705) is the largest finite
# float64) and reciprocal guard, per dtype (polarized_coupling.py:224-260):
# float32's make sense because couple_matter_c works in per-step optical
# depth units.
_SQRT_FLOOR = 1e-40
_EXP_MAX = 705.0


def _lims(x):
    """(sqrt floor, exp cap, reciprocal guard) for x's dtype."""
    if x.dtype == torch.float64:
        return _SQRT_FLOOR, _EXP_MAX, 0.0
    return 1e-16, 80.0, 1e-16


def _safe_recip(den, fallback=1.0):
    """1 / den, with lanes where |den| <= the guard taking 1 / fallback."""
    ok = torch.abs(den) > _lims(den)[2]
    return 1.0 / torch.where(ok, den, fallback)


def admissibility_clamp_c(s0, s1, s2, s3):
    """I >= 0 and sqrt(Q^2 + U^2 + V^2) <= I."""
    s0c = torch.clamp(s0, min=0.0)
    pol = s1 * s1 + s2 * s2 + s3 * s3
    need = pol > s0c * s0c
    factor = torch.where(
        need, s0c / torch.sqrt(torch.clamp(pol, min=_lims(pol)[0])), 1.0)
    return s0c, s1 * factor, s2 * factor, s3 * factor


def _rotate_c(s0, s1, s2, s3, rho1, rho3, rho_p, rho_sq, dl):
    """Faraday rotation alone (I A2-A5)."""
    cos_rho = torch.cos(rho_p * dl)
    sin_rho = torch.sin(rho_p * dl)
    sin_sq_rho = torch.sin(rho_p * dl / 2.0) ** 2
    inv_rho = _safe_recip(rho_p)
    inv_rho_sq = _safe_recip(rho_sq)
    rho_ss = rho1 * s1 + rho3 * s3
    r1 = (s1 * cos_rho + 2.0 * rho1 * rho_ss * inv_rho_sq * sin_sq_rho
          - rho3 * s2 * inv_rho * sin_rho)
    r2 = s2 * cos_rho + (rho3 * s1 - rho1 * s3) * inv_rho * sin_rho
    r3 = (s3 * cos_rho + 2.0 * rho3 * rho_ss * inv_rho_sq * sin_sq_rho
          + rho1 * s2 * inv_rho * sin_rho)
    return s0, r1, r2, r3


def _couple_simple_c(s0, s1, s2, s3, j0, j1, j3, a_i, dl, thin):
    """Emission with isotropic absorption (alpha_Q = alpha_V = 0)."""
    tau = a_i * dl
    inv_ai = _safe_recip(a_i)
    exp_neg = torch.exp(-tau)
    tau_c = torch.clamp(tau, max=_lims(tau)[1])
    small = tau_c < 1e-4
    em1_over_tau = torch.where(
        small, 1.0 + tau_c * (0.5 + tau_c * (1.0 / 6.0 + tau_c / 24.0)),
        torch.expm1(tau_c) / torch.where(small, 1.0, tau_c))
    edl = em1_over_tau * dl
    r0 = torch.where(thin, exp_neg * (s0 + j0 * edl), j0 * inv_ai)
    r1 = torch.where(thin, exp_neg * (s1 + j1 * edl), j1 * inv_ai)
    r2 = torch.where(thin, exp_neg * s2, 0.0)
    r3 = torch.where(thin, exp_neg * (s3 + j3 * edl), j3 * inv_ai)
    return r0, r1, r2, r3


def _couple_absorption_c(s0, s1, s2, s3, j0, j1, j3, a1, a3, a_i,
                         alpha_p, alpha_sq, dl, thin):
    """Emission with polarized absorption and no rotation (I A14-A17)."""
    tau = a_i * dl
    exp_neg_i = torch.exp(-tau)
    ap_dl = torch.clamp(alpha_p * dl, max=_lims(tau)[1])
    exp_neg_p = torch.exp(-ap_dl)
    sinh_p = torch.sinh(ap_dl)
    cosh_p = torch.cosh(ap_dl)
    coshm1_p = 0.5 * (torch.expm1(ap_dl) + exp_neg_p - 1.0)
    alpha_ss = a1 * s1 + a3 * s3
    alpha_j = a1 * j1 + a3 * j3
    inv_ai = _safe_recip(a_i)
    inv_ap = _safe_recip(alpha_p)
    inv_asq = _safe_recip(alpha_sq)
    fac = _safe_recip(a_i * a_i - alpha_sq)
    small = tau < 1e-4
    omexp_over = torch.where(
        small, 1.0 - tau * (0.5 - tau * (1.0 / 6.0 - tau / 24.0)),
        (1.0 - exp_neg_i) / torch.where(small, 1.0, tau))
    omexp_dl = omexp_over * dl

    t0_thin = ((s0 * cosh_p - alpha_ss * inv_ap * sinh_p) * exp_neg_i
               + alpha_j * fac * (-1.0 + (a_i * sinh_p + alpha_p * cosh_p)
                                  * inv_ap * exp_neg_p)
               + a_i * j0 * fac * (1.0 - (a_i * cosh_p + alpha_p * sinh_p)
                                   * inv_ai * exp_neg_p))
    t0_thick = (a_i * j0 - alpha_j) * fac

    def rest(aa, jj, ss):
        term_1 = (ss + aa * alpha_ss * inv_asq * coshm1_p
                  - s0 * aa * inv_ap * sinh_p) * exp_neg_i
        term_2 = jj * omexp_dl
        term_3 = alpha_j * aa * inv_ai * fac * (
            1.0 - (1.0 - a_i * a_i * inv_asq
                   - a_i * inv_asq * (a_i * cosh_p + alpha_p * sinh_p))
            * exp_neg_i)
        term_4 = j0 * aa * inv_ap * fac * (
            -alpha_p + (alpha_p * cosh_p + a_i * sinh_p) * exp_neg_i)
        thin_v = term_1 + term_2 + term_3 + term_4
        thick_v = (jj - aa * t0_thick) * inv_ai
        return torch.where(thin, thin_v, thick_v)

    r0 = torch.where(thin, t0_thin, t0_thick)
    r1 = rest(a1, j1, s1)
    r2 = torch.where(thin, s2 * exp_neg_i, 0.0)
    r3 = rest(a3, j3, s3)
    return r0, r1, r2, r3


def _gmatvec(p, q, pm, m4_00, m4_11, m4_22, m4_33, m4_02, m4_13,
             g01, g03, g12, v0, v1, v2, v3):
    """(p (I + M4) + q (I - M4) + r M2 + s M3) . v with the M2/M3
    sparsity folded into g01, g03, g12 and pm = p - q."""
    pq = p + q
    r0 = (pq + pm * m4_00) * v0 + g01 * v1 + pm * m4_02 * v2 + g03 * v3
    r1 = g01 * v0 + (pq + pm * m4_11) * v1 + g12 * v2 + pm * m4_13 * v3
    r2 = -pm * m4_02 * v0 - g12 * v1 + (pq + pm * m4_22) * v2
    r3 = g03 * v0 + pm * m4_13 * v1 + (pq + pm * m4_33) * v3
    return r0, r1, r2, r3


def _couple_matrix_c(s0, s1, s2, s3, j0, j1, j3, a1, a3, a_i, alpha_sq,
                     rho1, rho3, rho_sq, dl, thin):
    """Polarized absorption and rotation together (L 10, I 24), through
    the M1-M4 matrices' fixed sparsity."""
    alpha_rho = a1 * rho1 + a3 * rho3
    asr = alpha_sq - rho_sq
    floor = _lims(alpha_sq)[0]
    lambda_a = torch.sqrt(torch.clamp(asr * asr / 4.0
                                      + alpha_rho * alpha_rho, min=floor))
    lambda_b = asr / 2.0
    lam1 = torch.sqrt(torch.clamp(lambda_a + lambda_b, min=floor))
    lam2 = torch.sqrt(torch.clamp(lambda_a - lambda_b, min=floor))
    ctheta = lam1 * lam1 + lam2 * lam2
    inv_ct = _safe_recip(ctheta)
    sgn = torch.where(alpha_rho >= 0.0, 1.0, -1.0)

    m2_01 = (lam2 * a1 - sgn * lam1 * rho1) * inv_ct
    m2_03 = (lam2 * a3 - sgn * lam1 * rho3) * inv_ct
    m2_12 = (sgn * lam1 * a1 + lam2 * rho1) * inv_ct
    m3_01 = (lam1 * a1 + sgn * lam2 * rho1) * inv_ct
    m3_03 = (lam1 * a3 + sgn * lam2 * rho3) * inv_ct
    m3_12 = -(sgn * lam2 * a1 - lam1 * rho1) * inv_ct
    half_sum = (alpha_sq + rho_sq) / 2.0
    m4_00 = half_sum * 2.0 * inv_ct
    m4_11 = (a1 * a1 + rho1 * rho1 - half_sum) * 2.0 * inv_ct
    m4_22 = -half_sum * 2.0 * inv_ct
    m4_33 = (a3 * a3 + rho3 * rho3 - half_sum) * 2.0 * inv_ct
    m4_02 = (a1 * rho3 - a3 * rho1) * 2.0 * inv_ct
    m4_13 = (a3 * a1 + rho3 * rho1) * 2.0 * inv_ct

    tau = a_i * dl
    exp_t = torch.exp(-tau)
    lam1_dl = torch.clamp(lam1 * dl, max=_lims(lam1)[1])
    sin_t = torch.sin(lam2 * dl)
    cos_t = torch.cos(lam2 * dl)
    sinh_t = torch.sinh(lam1_dl)
    cosh_t = torch.cosh(lam1_dl)

    def gv(p, q, r, s, v0, v1, v2, v3):
        return _gmatvec(p, q, p - q, m4_00, m4_11, m4_22, m4_33, m4_02,
                        m4_13, r * m2_01 + s * m3_01, r * m2_03 + s * m3_03,
                        r * m2_12 + s * m3_12, v0, v1, v2, v3)

    o0, o1, o2, o3 = gv(0.5 * cosh_t, 0.5 * cos_t, -sin_t, -sinh_t,
                        s0, s1, s2, s3)
    f_1 = _safe_recip(a_i * a_i - lam1 * lam1)
    f_2 = _safe_recip(a_i * a_i + lam2 * lam2)
    zero = torch.zeros_like(j0)
    p0, p1, p2, p3 = gv(0.5 * a_i * f_1, 0.5 * a_i * f_2,
                        -lam2 * f_2, -lam1 * f_1, j0, j1, zero, j3)
    c0, c1, c2, c3 = gv(
        f_1 * 0.5 * (a_i * cosh_t + lam1 * sinh_t),
        f_2 * 0.5 * (a_i * cos_t - lam2 * sin_t),
        f_2 * (-lam2 * cos_t - a_i * sin_t),
        f_1 * (-lam1 * cosh_t - a_i * sinh_t),
        j0, j1, zero, j3)

    r0 = torch.where(thin, p0 - exp_t * c0 + exp_t * o0, p0)
    r1 = torch.where(thin, p1 - exp_t * c1 + exp_t * o1, p1)
    r2 = torch.where(thin, p2 - exp_t * c2 + exp_t * o2, p2)
    r3 = torch.where(thin, p3 - exp_t * c3 + exp_t * o3, p3)
    return r0, r1, r2, r3


def couple_matter_c(s0, s1, s2, s3, j0, j1, j3, a_i, a1, a3, rho1, rho3,
                    dl_cgs, rotation_split: bool):
    """One matter-coupling step; returns the Stokes (s0, s1, s2, s3) after
    it, clamped admissible.

    The inputs are first rescaled to per-step optical-depth units
    ((j, alpha, rho) -> dl (j, alpha, rho), dl -> 1), under which the
    coupling algebra is invariant. ``rotation_split`` Strang-splits the
    Faraday rotation from emission and absorption
    (image_rotation_split)."""
    return couple_matter_scaled_c(s0, s1, s2, s3, j0 * dl_cgs, j1 * dl_cgs,
                                  j3 * dl_cgs, a_i * dl_cgs, a1 * dl_cgs,
                                  a3 * dl_cgs, rho1 * dl_cgs, rho3 * dl_cgs,
                                  rotation_split)


def couple_matter_scaled_c(s0, s1, s2, s3, j0, j1, j3, a_i, a1, a3, rho1,
                           rho3, rotation_split: bool):
    """couple_matter_c with the coefficients already times the step (per
    -step optical-depth units, dl = 1): the form the polarized record
    holds (transfer/polarized.py sample_record)."""
    dl_cgs = torch.ones_like(j0)
    alpha_sq = a1 * a1 + a3 * a3
    rho_sq = rho1 * rho1 + rho3 * rho3
    a0_zero = a_i == 0.0
    ap_zero = alpha_sq == 0.0
    rp_zero = rho_sq == 0.0
    floor = _lims(alpha_sq)[0]
    alpha_p = torch.sqrt(torch.clamp(alpha_sq, min=floor))
    rho_p = torch.sqrt(torch.clamp(rho_sq, min=floor))
    thin = a_i * dl_cgs <= DELTA_TAU_MAX

    def sel(cond, a, b):
        return tuple(torch.where(cond, x, y) for x, y in zip(a, b))

    if rotation_split:
        def half_couple(ss):
            half = dl_cgs / 2.0
            r_free = (ss[0] + j0 * half, ss[1] + j1 * half,
                      ss[2], ss[3] + j3 * half)
            r_simple = _couple_simple_c(*ss, j0, j1, j3, a_i, half, thin)
            r_abs = _couple_absorption_c(*ss, j0, j1, j3, a1, a3, a_i,
                                         alpha_p, alpha_sq, half, thin)
            res = sel(a0_zero, r_free, sel(ap_zero, r_simple, r_abs))
            return admissibility_clamp_c(*res)

        ss = half_couple((s0, s1, s2, s3))
        rotated = _rotate_c(*ss, rho1, rho3, rho_p, rho_sq, dl_cgs)
        ss = admissibility_clamp_c(*sel(rp_zero, ss, rotated))
        return admissibility_clamp_c(*half_couple(ss))

    ss = (s0, s1, s2, s3)
    r1_ = (s0 + j0 * dl_cgs, s1 + j1 * dl_cgs, s2, s3 + j3 * dl_cgs)
    r2_ = _couple_simple_c(*ss, j0, j1, j3, a_i, dl_cgs, thin)
    rot = _rotate_c(*ss, rho1, rho3, rho_p, rho_sq, dl_cgs)
    r3_ = (rot[0] + j0 * dl_cgs, rot[1] + j1 * dl_cgs,
           rot[2], rot[3] + j3 * dl_cgs)
    r4_ = _couple_absorption_c(*ss, j0, j1, j3, a1, a3, a_i, alpha_p,
                               alpha_sq, dl_cgs, thin)
    r5_ = _couple_matrix_c(*ss, j0, j1, j3, a1, a3, a_i, alpha_sq,
                           rho1, rho3, rho_sq, dl_cgs, thin)
    res = sel(a0_zero & rp_zero, r1_,
              sel(ap_zero & rp_zero, r2_,
                  sel(a0_zero, r3_, sel(rp_zero, r4_, r5_))))
    return admissibility_clamp_c(*res)
