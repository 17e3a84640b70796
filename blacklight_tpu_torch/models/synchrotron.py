"""Thermal synchrotron emission and absorption from sampled GRMHD, on
tensors.

Port of the thermal subset of ``blacklight_tpu/models/synchrotron.py``:
``PlasmaParams`` and ``CutParams`` (:36-78), ``fluid_state`` in SKS
(:81-209), ``value_cuts`` (:212-230), ``pitch_angle`` (:242-276), the
Bessel K functions (:291-428), ``thermal_coefficients`` with its polarized
branch (j_Q, j_V, alpha_Q, alpha_V, rho_Q, rho_V; :785-936) and
``log_j_scale`` (:429-431); the reference is
simulation_coefficients.cpp:51-556 (2021 ApJ 921 17, eqs. 28-37).

Where the JAX package's forms depend on the dtype (floors in the fluid
state and the pitch angle, the float32 caps on nu_s, xx and h nu / kT,
the float32 e^x-scaled Bessel ratios and log-space rho_V trap), the port
keeps both branches as they are: float64 follows the reference's literal
forms, float32 the ones that keep single precision finite.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from blacklight_tpu_torch.constants import Math, Physics, PlasmaModel
from blacklight_tpu_torch.ops import sks

THETA_E_ZERO = 0.01  # reference radiation_integrator.hpp:190

@dataclasses.dataclass(frozen=True)
class PlasmaParams:
    """Plasma model parameters (reference input_reader.hpp:163-178)."""

    mu: float
    ne_ni: float
    model: PlasmaModel
    use_p: bool = True
    gamma: float = 5.0 / 3.0
    gamma_i: float = 5.0 / 3.0
    gamma_e: float = 4.0 / 3.0
    rat_low: float = 1.0
    rat_high: float = 1.0
    power_frac: float = 0.0
    power_p: float = 0.0
    gamma_min: float = 0.0
    gamma_max: float = 0.0
    kappa_frac: float = 0.0
    kappa: float = 0.0
    w: float = 0.0

    @property
    def thermal_frac(self):
        return 1.0 - (self.power_frac + self.kappa_frac)


@dataclasses.dataclass(frozen=True)
class CutParams:
    """Value cuts (negative = off; reference input_reader.hpp:181-194)."""

    rho_min: float = -1.0
    rho_max: float = -1.0
    n_e_min: float = -1.0
    n_e_max: float = -1.0
    p_gas_min: float = -1.0
    p_gas_max: float = -1.0
    theta_e_min: float = -1.0
    theta_e_max: float = -1.0
    b_min: float = -1.0
    b_max: float = -1.0
    sigma_min: float = -1.0
    sigma_max: float = -1.0
    beta_inverse_min: float = -1.0
    beta_inverse_max: float = -1.0

    def pairs(self):
        """(state key, min, max) in the order value_cuts applies them."""
        return (("rho_cgs", self.rho_min, self.rho_max),
                ("n_e_cgs", self.n_e_min, self.n_e_max),
                ("pgas_cgs", self.p_gas_min, self.p_gas_max),
                ("theta_e", self.theta_e_min, self.theta_e_max),
                ("bb_cgs", self.b_min, self.b_max),
                ("sigma", self.sigma_min, self.sigma_max),
                ("beta_inv", self.beta_inverse_min, self.beta_inverse_max))


def fluid_state(pos, samples, spin, plasma: PlasmaParams, rho_unit: float):
    """CGS fluid state and CKS four-vectors at CKS positions ``pos``
    (B, 4) from sampled SKS primitives (simulation_coefficients.cpp:
    287-358 and the Jacobian :397-431).

    Returns a dict with rho_cgs, pgas_cgs, n_e_cgs, bb_cgs, sigma,
    beta_inv, theta_e, kb_tt_e_cgs, ucon and bcon (each a tuple of four
    (B,) CKS components) and b_sq.
    """
    if plasma.model != PlasmaModel.ti_te_beta:
        raise ValueError("the port's fluid state covers ti_te_beta")
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    rho, pgas = samples["rho"], samples["pgas"]
    uu1, uu2, uu3 = samples["uu1"], samples["uu2"], samples["uu3"]
    bb1, bb2, bb3 = samples["bb1"], samples["bb2"], samples["bb3"]

    d_unit = rho_unit
    e_unit = d_unit * Physics.c ** 2
    b_unit = math.sqrt(4.0 * Math.pi * e_unit)
    rho_cgs = rho * d_unit
    pgas_cgs = pgas * e_unit
    n_cgs = rho_cgs / (plasma.mu * Physics.m_p)
    n_e_cgs = n_cgs / (1.0 + 1.0 / plasma.ne_ni)

    m = sks.sks_metric(x, y, z, spin)
    ut, ur, uth, uph = sks.normal_frame_velocity(m, uu1, uu2, uu3)
    _, ucov_r, ucov_th, ucov_ph = sks.lower_sks(m, ut, ur, uth, uph)
    # b^mu from the cell-frame field (simulation_coefficients.cpp:315-328)
    bt = ucov_r * bb1 + ucov_th * bb2 + ucov_ph * bb3
    br = (bb1 + bt * ur) / ut
    bth = (bb2 + bt * uth) / ut
    bph = (bb3 + bt * uph) / ut
    bcov_t, bcov_r, bcov_th, bcov_ph = sks.lower_sks(m, bt, br, bth, bph)
    b_sq = bcov_t * bt + bcov_r * br + bcov_th * bth + bcov_ph * bph

    f64 = b_sq.dtype == torch.float64
    if f64:
        pos_b = b_sq > 0.0
        bb_cgs = torch.where(pos_b, torch.sqrt(torch.where(pos_b, b_sq, 1.0)),
                             0.0) * b_unit
    else:
        bb_cgs = torch.sqrt(torch.clamp(b_sq, min=1e-30)) * b_unit
    # divisors floored at the point of use: rho and pgas may be an exact
    # zero fallback value
    dfloor = 1e-30 if f64 else 1e-15
    sigma = b_sq / torch.clamp(rho, min=dfloor)
    beta_inv = b_sq / torch.clamp(2.0 * pgas, min=dfloor)

    # electron temperature (simulation_coefficients.cpp:330-358), with
    # (rat_high + rat_low b^2) / (1 + b^2) in the form that passes
    # beta_inv = inf
    u_b = 1.0 / (1.0 + beta_inv ** 2)
    tti_tte = plasma.rat_high * u_b + plasma.rat_low * (1.0 - u_b)
    kb_tt_tot_cgs = (plasma.mu * Physics.m_p * Physics.c ** 2) \
        * (pgas / torch.clamp(rho, min=dfloor))
    if plasma.use_p:
        kb_tt_e_cgs = (1.0 + plasma.ne_ni) / (tti_tte + plasma.ne_ni) \
            * kb_tt_tot_cgs
    else:
        kb_tt_e_cgs = (1.0 + plasma.ne_ni) * kb_tt_tot_cgs \
            / (plasma.gamma - 1.0)
        kb_tt_e_cgs = kb_tt_e_cgs / (tti_tte / (plasma.gamma_i - 1.0)
                                     + plasma.ne_ni / (plasma.gamma_e - 1.0))
    theta_e = kb_tt_e_cgs / (Physics.m_e * Physics.c ** 2)

    ux, uy, uz = sks.sks_to_cks_vector(ur, uth, uph, x, y, z, spin)
    bx, by, bz = sks.sks_to_cks_vector(br, bth, bph, x, y, z, spin)
    return dict(rho_cgs=rho_cgs, pgas_cgs=pgas_cgs, n_e_cgs=n_e_cgs,
                bb_cgs=bb_cgs, sigma=sigma, beta_inv=beta_inv,
                theta_e=theta_e, kb_tt_e_cgs=kb_tt_e_cgs,
                ucon=(ut, ux, uy, uz), bcon=(bt, bx, by, bz), b_sq=b_sq)


def value_cuts(state, cuts: CutParams):
    """(B,) keep mask of the cell-value cuts
    (simulation_coefficients.cpp:361-375)."""
    keep = torch.ones_like(state["sigma"], dtype=torch.bool)
    for name, lo, hi in cuts.pairs():
        if lo >= 0.0:
            keep &= ~(state[name] < lo)
        if hi >= 0.0:
            keep &= ~(state[name] > hi)
    return keep


def cell_values(state):
    """(B, NUM_CELL_VALUES) diagnostic values, in CELL_VALUE_NAMES order
    (simulation_coefficients.cpp:377-387)."""
    return torch.stack([
        state["rho_cgs"], state["n_e_cgs"], state["pgas_cgs"],
        state["theta_e"], state["bb_cgs"], state["sigma"], state["beta_inv"],
    ], dim=-1)


def pitch_angle(kcov, state):
    """Fluid-frame angle between the wavevector ``kcov`` (four (B,)
    covariant CKS components) and the field, from invariants:
    cos(theta_B) = (k.b) / (|k.u| sqrt(b.b)).

    Returns (sin_theta_b, cos_theta_b, sin2_theta_b, u_dot_k).
    """
    k0, k1, k2, k3 = kcov
    ut, ux, uy, uz = state["ucon"]
    bt, bx, by, bz = state["bcon"]
    u_dot_k = ut * k0 + ux * k1 + uy * k2 + uz * k3
    b_dot_k = bt * k0 + bx * k1 + by * k2 + bz * k3
    b_sq = state["b_sq"]
    f64 = b_sq.dtype == torch.float64
    denom = u_dot_k * u_dot_k * torch.clamp(b_sq,
                                            min=1e-300 if f64 else 1e-16)
    cos2 = torch.clamp(b_dot_k * b_dot_k / denom, max=1.0)
    sin2 = 1.0 - cos2
    cut = 1e-300 if f64 else 1e-24

    def safe_sqrt(v):
        return torch.where(v > cut, torch.sqrt(torch.where(v > cut, v, 1.0)),
                           0.0)

    sin_theta_b = safe_sqrt(sin2)
    cos_theta_b = safe_sqrt(cos2) * torch.where(b_dot_k >= 0.0, 1.0, -1.0)
    return sin_theta_b, cos_theta_b, sin2, u_dot_k


def log_j_scale(nu0: float) -> float:
    """log of the emissivity unit e^2 / (c nu0^2) taken out of j."""
    return 2.0 * math.log(Physics.e) - math.log(Physics.c) \
        - 2.0 * math.log(nu0)


def log_kirchhoff(nu0: float) -> float:
    """log of e^2 c / (2 h nu0^2), which turns the scaled j into alpha."""
    return (2.0 * math.log(Physics.e) + math.log(Physics.c)
            - math.log(2.0 * Physics.h) - 2.0 * math.log(nu0))


def cbrt(x):
    """Real cube root, odd in x (torch has no cbrt)."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_EULER_GAMMA = 0.5772156649015328606
# Terms of the small-argument K0/K1 series and iterations of the Steed CF2
# (models/synchrotron.py:279-288): full float64 convergence on each side of
# the x = 3 switch.
_BESSEL_SERIES_TERMS = 22
_BESSEL_CF2_ITERS = 40


def _bessel_k01_small(x):
    """K0, K1 by the ascending series (DLMF 10.31.2-3), for x <= 3."""
    t = x * x / 4.0
    i0 = torch.ones_like(x)
    k0_sum = torch.zeros_like(x)
    i1_sum = torch.ones_like(x)
    k1_sum = torch.full_like(x, 1.0 - 2.0 * _EULER_GAMMA)
    tk = torch.ones_like(x)
    fact = 1.0
    h = 0.0
    for k in range(1, _BESSEL_SERIES_TERMS + 1):
        fact *= k
        h += 1.0 / k
        tk = tk * t
        inv_sq = 1.0 / (fact * fact)
        i0 = i0 + tk * inv_sq
        k0_sum = k0_sum + tk * inv_sq * h
        inv_11 = 1.0 / (fact * fact * (k + 1.0))
        i1_sum = i1_sum + tk * inv_11
        k1_sum = k1_sum + tk * inv_11 * (2.0 * h + 1.0 / (k + 1.0)
                                         - 2.0 * _EULER_GAMMA)
    lnx2 = torch.log(x / 2.0)
    i1 = 0.5 * x * i1_sum
    k0 = -(lnx2 + _EULER_GAMMA) * i0 + k0_sum
    k1 = 1.0 / x + lnx2 * i1 - 0.25 * x * k1_sum
    return k0, k1


def _bessel_k01_large(x, scaled=False):
    """K0, K1 for x >= 2 by Steed's continued fraction CF2 (Temme's
    method, mu = 0); ``scaled`` returns e^x K."""
    a1 = 0.25
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    q = torch.full_like(x, a1)
    c = torch.full_like(x, a1)
    a = -a1
    s = 1.0 + q * delh
    for i in range(2, _BESSEL_CF2_ITERS + 2):
        a = a - 2.0 * (i - 1)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q1, q2 = q2, qnew
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        h = h + delh
        s = s + q * delh
    h = a1 * h
    pref = torch.sqrt(math.pi / (2.0 * x))
    if not scaled:
        pref = pref * torch.exp(-x)
    k0 = pref / s
    k1 = k0 * (x + 0.5 - h) / x
    return k0, k1


def _bessel_k01_asymptotic(x, terms: int = 8):
    """e^x K0, e^x K1 from the large-x asymptotic series (float32 only:
    the CF2's recurrences overflow single precision)."""
    inv = 1.0 / x
    p0 = torch.ones_like(x)
    p1 = torch.ones_like(x)
    a0 = 1.0
    a1 = 1.0
    xk = inv
    for k in range(1, terms + 1):
        m = (2.0 * k - 1.0) ** 2
        a0 *= (0.0 - m) / (8.0 * k)
        a1 *= (4.0 - m) / (8.0 * k)
        p0 = p0 + a0 * xk
        p1 = p1 + a1 * xk
        xk = xk * inv
    pref = torch.sqrt(math.pi / (2.0 * x))
    return pref * p0, pref * p1


def _bessel_k012_scaled(x):
    """(e^x K0, e^x K1, e^x K2), which cannot underflow: the series below
    x = 3, above it the CF2 in float64 and the asymptotic series in
    float32."""
    small = x <= 3.0
    xs = torch.where(small, torch.clamp(x, min=1e-30), 3.0)
    xl = torch.where(small, 3.0, x)
    k0_s, k1_s = _bessel_k01_small(xs)
    e = torch.exp(xs)
    if x.dtype == torch.float64:
        k0_l, k1_l = _bessel_k01_large(xl, scaled=True)
    else:
        k0_l, k1_l = _bessel_k01_asymptotic(xl)
    k0 = torch.where(small, k0_s * e, k0_l)
    k1 = torch.where(small, k1_s * e, k1_l)
    return k0, k1, k0 + 2.0 * k1 / x


def _bessel_k(order: int, x):
    """Modified Bessel K_0, K_1 or K_2 (K2 = K0 + 2 K1 / x): the series
    below x = 3, the CF2 above."""
    small = x <= 3.0
    xs = torch.where(small, torch.clamp(x, min=1e-300), 3.0)
    xl = torch.where(small, 3.0, x)
    k0_s, k1_s = _bessel_k01_small(xs)
    k0_l, k1_l = _bessel_k01_large(xl)
    k0 = torch.where(small, k0_s, k0_l)
    k1 = torch.where(small, k1_s, k1_l)
    if order == 0:
        return k0
    if order == 1:
        return k1
    return k0 + 2.0 * k1 / x


def thermal_coefficients(nu_cgs, nu0: float, state, sin_theta_b,
                         plasma: PlasmaParams, *, cos_theta_b=None,
                         sin2_theta_b=None, polarized: bool = False):
    """Thermal synchrotron coefficients at fluid-frame frequencies
    ``nu_cgs`` (B, F).

    j's are the invariant emissivities divided by exp(log_j_scale(nu0));
    alphas the true invariant absorptivities, through Kirchhoff's law with
    the reference's overflow trap (simulation_coefficients.cpp:469-524).
    Returns (j_i, alpha_i), each (B, F); with ``polarized`` (which needs
    cos_theta_b and sin2_theta_b) a dict of j_i, j_q, j_v, alpha_i,
    alpha_q, alpha_v and the Faraday rotativities rho_q, rho_v
    (:526-556), each (B, F).
    """
    theta_e = state["theta_e"][..., None]
    kb_tt_e = state["kb_tt_e_cgs"][..., None]
    n_e = state["n_e_cgs"][..., None]
    sin_b = sin_theta_b[..., None]
    f64 = nu_cgs.dtype == torch.float64
    frac = plasma.thermal_frac

    nu_c = Physics.e * state["bb_cgs"][..., None] \
        / (2.0 * Math.pi * Physics.m_e * Physics.c)
    nu_s = 2.0 / 9.0 * nu_c * theta_e ** 2 * sin_b
    nu_s = torch.clamp(nu_s, min=1e-300 if f64 else 1e-12)
    xx = nu_cgs / nu_s
    if not f64:
        xx = torch.clamp(xx, max=1e20)
    xx_1_3 = cbrt(xx)
    xx_1_2 = torch.sqrt(xx)
    xx_1_6 = torch.sqrt(xx_1_3)
    coefficient = frac * n_e * nu_c * (nu0 / nu_cgs) ** 2 \
        * torch.exp(-xx_1_3)
    var_a = Math.sqrt2 * Math.pi / 27.0 * sin_b
    var_b = 2.0 ** (11.0 / 12.0)
    var_c = xx_1_2 + var_b * xx_1_6
    j_i = coefficient * var_a * var_c * var_c

    if f64:
        hnu_kt = Physics.h * nu_cgs / kb_tt_e
    else:
        hnu_kt = torch.clamp(Physics.h * nu_cgs
                             / torch.clamp(kb_tt_e, min=1e-18), max=87.0)
    kirchhoff = torch.expm1(hnu_kt) * math.exp(log_kirchhoff(nu0))
    alpha_i = j_i * kirchhoff
    trap = torch.isinf(1.0 / (alpha_i * alpha_i))
    if not polarized:
        return j_i, torch.where(trap, 0.0, alpha_i)

    cos_b = cos_theta_b[..., None]
    sin2_b = sin2_theta_b[..., None]
    # j_Q, j_V (M 29-30): float32 floors theta_e inside the power and the
    # division; float64 divides by it literally
    theta_f = theta_e if f64 else torch.clamp(theta_e, min=1e-15)
    var_d = (7.0 * theta_f ** 0.96 + 35.0) \
        / (10.0 * theta_f ** 0.96 + 75.0) * var_b
    var_e = xx_1_2 + var_d * xx_1_6
    var_f = cos_b / theta_f
    var_g = (Math.pi / 3.0 + Math.pi / 3.0 * xx_1_3 + 2.0 / 300.0 * xx_1_2
             + 2.0 / 19.0 * Math.pi * xx_1_3 ** 2)
    j_q = -coefficient * var_a * var_e * var_e
    j_v = coefficient * var_f * var_g
    out = {"j_i": j_i, "j_q": j_q, "j_v": j_v,
           "alpha_i": torch.where(trap, 0.0, alpha_i),
           "alpha_q": torch.where(trap, 0.0, j_q * kirchhoff),
           "alpha_v": torch.where(trap, 0.0, j_v * kirchhoff)}

    # Faraday rotativities (M 33-37)
    nu_2 = nu_cgs * nu_cgs
    coefficient_q = -frac * n_e * Physics.e ** 2 * nu_c ** 2 * sin2_b \
        / (Physics.m_e * Physics.c * nu_2)
    coefficient_v = frac * 2.0 * n_e * Physics.e ** 2 * nu_c * cos_b \
        / (Physics.m_e * Physics.c * nu_cgs)
    xx_neg_1_2 = 1.0 / torch.sqrt(xx)
    var_a2 = 2.011 * torch.exp(-19.78 * xx ** (-0.5175))
    var_b2 = torch.cos(39.89 * xx_neg_1_2) * torch.exp(-70.16 * xx ** (-0.6))
    var_c2 = 0.011 * torch.exp(-1.69 * xx_neg_1_2)
    var_d2 = 0.003135 * xx ** (4.0 / 3.0)
    var_e2 = 0.5 * (1.0 + torch.tanh(10.0 * torch.log(0.6648 * xx_neg_1_2)))
    f_0 = var_a2 - var_b2 - var_c2
    f_m = f_0 + (var_c2 - var_d2) * var_e2
    if f64:
        # the reference's literal (K0 - delta) / K2 with its < 0 / > 1 trap
        inv_theta = 1.0 / torch.clamp(theta_e, min=THETA_E_ZERO)
        kk_0 = _bessel_k(0, inv_theta)
        kk_1 = _bessel_k(1, inv_theta)
        kk_2 = _bessel_k(2, inv_theta)
        delta_jj_5 = 0.4379 * torch.log(1.0 + 1.3414 * xx ** (-0.7515))
        factor_q = f_m * (kk_1 / kk_2 + 6.0 * theta_e)
        factor_v = (kk_0 - delta_jj_5) / kk_2
        factor_v = torch.where((factor_v < 0.0) | (factor_v > 1.0), 1.0,
                               factor_v)
    else:
        # e^x-scaled K's (the unscaled ones underflow float32 near x ~ 80)
        # and the trap taken in log space, where delta e^x cannot overflow
        inv_theta = torch.clamp(
            1.0 / torch.clamp(theta_e, min=THETA_E_ZERO), min=1e-15)
        kk_0s, kk_1s, kk_2s = _bessel_k012_scaled(inv_theta)
        delta_jj_5 = 0.4379 * torch.log1p(1.3414 * xx ** (-0.7515))
        factor_q = f_m * (kk_1s / kk_2s + 6.0 * theta_e)
        log_de = torch.log(torch.clamp(delta_jj_5, min=1e-30)) + inv_theta
        log_k0s = torch.log(kk_0s)
        ok_v = log_de <= log_k0s
        de = torch.exp(torch.minimum(log_de, log_k0s))
        factor_v = torch.where(ok_v, (kk_0s - de) / kk_2s, 1.0)
    cold = theta_e < THETA_E_ZERO
    out["rho_q"] = coefficient_q * torch.where(cold, 0.0, factor_q)
    out["rho_v"] = coefficient_v * torch.where(cold, 1.0, factor_v)
    return out
