"""Synchrotron emission, absorption and rotation from sampled GRMHD, on
tensors.

Port of ``blacklight_tpu/models/synchrotron.py``: ``PlasmaParams`` and
``CutParams`` (:36-78), ``fluid_state`` in SKS and in CKS with the
ti_te_beta and the code_kappa electron temperature (:81-209),
``value_cuts`` (:212-230), ``pitch_angle`` (:242-276),
the Bessel K functions (:291-428), ``log_j_scale`` (:429-431), the
thermal population (``thermal_coefficients`` with its polarized branch:
j_Q, j_V, alpha_Q, alpha_V, rho_Q, rho_V; :785-936), the power-law and
kappa populations with their host constants (``hypergeometric`` :434,
``powerlaw_constants`` :451, ``kappa_constants`` :475,
``powerlaw_coefficients`` :556, ``kappa_coefficients`` :665) and their
sum, ``all_coefficients`` (:751); the reference is
simulation_coefficients.cpp:51-773 (2021 ApJ 921 17, eqs. 28-54).

Where the JAX package's forms depend on the dtype (floors in the fluid
state and the pitch angle, the float32 caps on nu_s, xx and h nu / kT,
the float32 e^x-scaled Bessel ratios and log-space rho_V trap), the port
keeps both branches as they are: float64 follows the reference's literal
forms, float32 the ones that keep single precision finite.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from blacklight_tpu_torch.constants import Math, Physics, PlasmaModel
from blacklight_tpu_torch.ops import geometry, sks

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


def fluid_state(pos, samples, spin, plasma: PlasmaParams, rho_unit: float,
                coords: str = "sks"):
    """CGS fluid state and CKS four-vectors at CKS positions ``pos``
    (B, 4) from sampled primitives (simulation_coefficients.cpp:287-358):
    with ``coords`` "sks" the primitives are SKS and u, b go to CKS by the
    Jacobian (:397-431); with "cks" (AthenaK) they are CKS already, the
    normal-frame velocity and the cell-frame field taken in the CKS metric
    (the geodesics' own, radiation_geometry.cpp:425-458), and no Jacobian
    applies (the JAX package's :110-129).

    The electron temperature follows ``plasma.model``: ti_te_beta from
    the gas temperature and the ion-to-electron ratio, code_kappa from
    the sampled electron entropy ``samples["kappa"]`` (:330-358).

    Returns a dict with rho_cgs, pgas_cgs, n_e_cgs, bb_cgs, sigma,
    beta_inv, theta_e, kb_tt_e_cgs, ucon and bcon (each a tuple of four
    (B,) CKS components) and b_sq.
    """
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

    if coords == "cks":
        ucon, bcon, b_sq = cks_frame(pos, spin, (uu1, uu2, uu3),
                                     (bb1, bb2, bb3))
    elif coords == "sks":
        m = sks.sks_metric(x, y, z, spin)
        ut, ur, uth, uph = sks.normal_frame_velocity(m, uu1, uu2, uu3)
        _, ucov_r, ucov_th, ucov_ph = sks.lower_sks(m, ut, ur, uth, uph)
        # b^mu from the cell-frame field (simulation_coefficients.cpp:
        # 315-328)
        bt = ucov_r * bb1 + ucov_th * bb2 + ucov_ph * bb3
        br = (bb1 + bt * ur) / ut
        bth = (bb2 + bt * uth) / ut
        bph = (bb3 + bt * uph) / ut
        bcov_t, bcov_r, bcov_th, bcov_ph = sks.lower_sks(m, bt, br, bth, bph)
        b_sq = bcov_t * bt + bcov_r * br + bcov_th * bth + bcov_ph * bph
    else:
        raise ValueError(f"unknown simulation coordinates {coords!r}")

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

    # electron temperature (simulation_coefficients.cpp:330-358)
    if plasma.model == PlasmaModel.ti_te_beta:
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
            kb_tt_e_cgs = kb_tt_e_cgs / (
                tti_tte / (plasma.gamma_i - 1.0)
                + plasma.ne_ni / (plasma.gamma_e - 1.0))
        theta_e = kb_tt_e_cgs / (Physics.m_e * Physics.c ** 2)
    elif plasma.model == PlasmaModel.code_kappa:
        theta_e, kb_tt_e_cgs = code_kappa_temperature(rho, samples["kappa"],
                                                      plasma)
    else:
        raise ValueError(f"unknown plasma model {plasma.model!r}")

    if coords == "sks":
        ux, uy, uz = sks.sks_to_cks_vector(ur, uth, uph, x, y, z, spin)
        bx, by, bz = sks.sks_to_cks_vector(br, bth, bph, x, y, z, spin)
        ucon, bcon = (ut, ux, uy, uz), (bt, bx, by, bz)
    return dict(rho_cgs=rho_cgs, pgas_cgs=pgas_cgs, n_e_cgs=n_e_cgs,
                bb_cgs=bb_cgs, sigma=sigma, beta_inv=beta_inv,
                theta_e=theta_e, kb_tt_e_cgs=kb_tt_e_cgs,
                ucon=ucon, bcon=bcon, b_sq=b_sq)


def code_kappa_temperature(rho, kappa, plasma: PlasmaParams):
    """(theta_e, kb_tt_e_cgs) of plasma_model = code_kappa from the
    sampled density ``rho`` and electron entropy ``kappa`` (code units;
    simulation_coefficients.cpp:351-358), in the JAX package's form
    0.2 (sqrt(1 + 25 cbrt(rho_e kappa)^2) - 1), which cancels for cold
    cells in float32 as the reference's does. The cube root is ``cbrt``'s
    |x|^(1/3), the form csrc/sim_sample.cuh cbrt_s writes, so that the
    kernels and this plain version round alike; against a true cube root
    (the JAX package's jnp.cbrt) it differs by the rounding of 1/3 times
    |ln x|: ~1e-15 relative in float64, up to ~2e-6 in float32."""
    mu_e = plasma.mu * (1.0 + 1.0 / plasma.ne_ni)
    rho_e = rho * Physics.m_e / (mu_e * Physics.m_p)
    rho_kappa_e_cbrt = cbrt(rho_e * kappa)
    theta_e = 0.2 * (torch.sqrt(1.0 + 25.0 * rho_kappa_e_cbrt ** 2) - 1.0)
    return theta_e, theta_e * Physics.m_e * Physics.c ** 2


def cks_frame(pos, spin, uu, bb):
    """u^mu, b^mu (four (B,) CKS components each) and b^2 from the CKS
    normal-frame velocity ``uu`` and cell-frame field ``bb`` (three (B,)
    components each) at CKS positions ``pos`` (B, 4), in the Kerr-Schild
    metric g_{mu nu} = eta + f l_mu l_nu (ops/geometry.py gcov_gcon's
    terms): uu^0 = sqrt(1 + g_ij uu^i uu^j), the lapse 1 / sqrt(1 + f)
    and the shift f l_i / (1 + f) (g^{00} = -(1 + f), g^{0i} = f l_i),
    u^0 = uu^0 / lapse, u^i = uu^i - shift^i u^0; b^0 = u_i bb^i and
    b^i = (bb^i + b^0 u^i) / u^0. Each sum runs over its index in order,
    the forms csrc/sim_sample.cuh fluid_state_cks writes."""
    _, f, l_lower = geometry.ks_scalars(pos[..., 1:], spin)
    l = l_lower.unbind(-1)
    fl = [f * li for li in l]
    # g[m][n], m, n = 0..3, with l_0 = 1
    g = [[f - 1.0, *fl]]
    g += [[fl[i], *((1.0 + fl[i] * l[j]) if i == j else fl[i] * l[j]
                    for j in range(3))] for i in range(3)]
    rows = [g[i + 1][1] * uu[0] + g[i + 1][2] * uu[1] + g[i + 1][3] * uu[2]
            for i in range(3)]
    uu0 = torch.sqrt(1.0 + (uu[0] * rows[0] + uu[1] * rows[1]
                            + uu[2] * rows[2]))
    lapse = 1.0 / torch.sqrt(1.0 + f)
    ut = uu0 / lapse
    ucon = (ut, *(uu[i] - fl[i] / (1.0 + f) * ut for i in range(3)))

    def lower(v):
        return [g[m][0] * v[0] + g[m][1] * v[1] + g[m][2] * v[2]
                + g[m][3] * v[3] for m in range(4)]

    ucov = lower(ucon)
    bt = ucov[1] * bb[0] + ucov[2] * bb[1] + ucov[3] * bb[2]
    bcon = (bt, *((bb[i] + bt * ucon[i + 1]) / ut for i in range(3)))
    bcov = lower(bcon)
    b_sq = (bcov[0] * bcon[0] + bcov[1] * bcon[1] + bcov[2] * bcon[2]
            + bcov[3] * bcon[3])
    return ucon, bcon, b_sq


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


# ---------------------------------------------------------------------------
# Power-law and kappa populations (M 38-54)


def hypergeometric(alpha: float, beta: float, gamma: float, z: float) -> float:
    """2F1 by the Pfaff transformation and a 10-term series
    (simulation_coefficients.cpp:740-773); a host scalar."""
    a, bb, c = alpha, gamma - beta, gamma
    x = z / (z - 1.0)
    result = 1.0
    a_k = b_k = c_k = xk = k_fact = 1.0
    for k in range(1, 11):
        a_k *= a + k - 1.0
        b_k *= bb + k - 1.0
        c_k *= c + k - 1.0
        xk *= x
        k_fact *= k
        result += a_k * b_k * xk / (c_k * k_fact)
    return result * (1.0 - z) ** (-alpha)


def powerlaw_constants(p: PlasmaParams) -> dict:
    """The power-law population's constants (M 38-42;
    simulation_coefficients.cpp:54-80), float64 host scalars."""
    pp = p.power_p
    var_c = p.gamma_min ** (1.0 - pp) - p.gamma_max ** (1.0 - pp)
    return {
        "jj": (3.0 ** (pp / 2.0) * (pp - 1.0)) / (2.0 * (pp + 1.0)) / var_c
              * math.gamma((3.0 * pp - 1.0) / 12.0)
              * math.gamma((3.0 * pp + 19.0) / 12.0),
        "aa": (3.0 ** ((pp + 1.0) / 2.0) * (pp - 1.0) / 4.0) / var_c
              * math.gamma((3.0 * pp + 2.0) / 12.0)
              * math.gamma((3.0 * pp + 22.0) / 12.0),
        "jj_q": -(pp + 1.0) / (pp + 7.0 / 3.0),
        "jj_v": 0.684 * pp ** 0.49,
        "aa_q": -((0.034 * pp - 0.0344) ** 0.086),
        "aa_v": (0.71 * pp + 0.0352) ** 0.394,
        "rho": (pp - 1.0) / var_c,
        "rho_q": -(p.gamma_min ** (2.0 - pp)) / (pp / 2.0 - 1.0),
        "rho_v": (2.0 * (pp + 2.0) / (pp + 1.0)) * p.gamma_min ** (-(pp + 1.0))
                 * math.log(p.gamma_min),
    }


def kappa_constants(p: PlasmaParams, polarized: bool = False) -> dict:
    """The kappa population's constants (M 43-54;
    simulation_coefficients.cpp:82-193): the bracket coefficients, the
    Bessel ratio K0 / K2 at 1 / w and the interpolation between the two
    kappa brackets around p.kappa, float64 host scalars.

    The reference's quirk stays: kappa_aa_high_i is set only for a
    polarized image (simulation_coefficients.cpp:120) yet the unpolarized
    alpha_I bridge reads it (:661), so an unpolarized run has no kappa
    absorption; ``polarized`` is the route's."""
    kap, w = p.kappa, p.w
    var_h = w * kap
    one_over_w = torch.tensor(1.0 / w, dtype=torch.float64)
    out = {
        "jj_low": (4.0 * Math.pi * math.gamma(kap - 4.0 / 3.0))
                  / (3.0 ** (7.0 / 3.0) * math.gamma(kap - 2.0)),
        "jj_high": (3.0 ** ((kap - 1.0) / 2.0) * (kap - 2.0) * (kap - 1.0) / 4.0
                    * math.gamma(kap / 4.0 - 1.0 / 3.0)
                    * math.gamma(kap / 4.0 + 4.0 / 3.0)),
        "jj_x_i": 3.0 * kap ** (-1.5),
        "aa_low": (3.0 ** (1.0 / 6.0) * 10.0 / 41.0
                   * 2.0 * Math.pi * var_h ** (kap - 10.0 / 3.0)
                   * ((kap - 2.0) * (kap - 1.0) * kap) / (3.0 * kap - 1.0)
                   * math.gamma(5.0 / 3.0)
                   * hypergeometric(kap - 1.0 / 3.0, kap + 1.0, kap + 2.0 / 3.0,
                                    -var_h)),
        "aa_high": (Math.pi ** 1.5 / 3.0
                    * ((kap - 2.0) * (kap - 1.0) * kap / var_h ** 3)
                    * (2.0 * math.gamma(2.0 + kap / 2.0) / (2.0 + kap) - 1.0)),
        "aa_x_i": (-1.75 + 1.6 * kap) ** (-0.86),
        "jj_low_q": 0.5,
        "jj_low_v": 0.5625 * kap ** (-0.528) / w,
        "jj_high_q": 0.64 + 0.02 * kap,
        "jj_high_v": 0.765625 * kap ** (-0.44) / w,
        "jj_x_q": 3.7 * kap ** (-1.6),
        "jj_x_v": 3.0 * kap ** (-1.5),
        "aa_low_q": 25.0 / 48.0,
        "aa_low_v": 77.0 / (100.0 * w) * kap ** (-0.7),
        "aa_high_i": ((3.0 / kap) ** 4.75 + 0.6) if polarized else 0.0,
        "aa_high_q": 441.0 * kap ** (-5.76) + 0.55,
        "aa_high_v": (14.3 * w ** (-0.928))
                     * (169.0 * kap ** (-8.0) + 0.0052 * kap - 0.0526
                        + 47.0 / (200.0 * kap)),
        "aa_x_q": 1.4 * kap ** (-1.15),
        "aa_x_v": 1.22 * kap ** (-1.136) + 0.007,
        "rho_v": float(_bessel_k(0, one_over_w) / _bessel_k(2, one_over_w)),
    }

    def q_set(a, bb, c, d, e):
        return dict(a=a, b=bb, c=c, d=d, e=e)

    q35 = q_set(17.0 * w + math.sqrt(w) * (-3.0 + 7.0 * math.exp(-5.0 * w)),
                -1.0 / 30.0, 0.1, -1.5, 0.471)
    q40 = q_set(46.0 / 3.0 * w + math.sqrt(w) * (-5.0 / 3.0
                                                 + 17.0 / 3.0 * math.exp(-5.0 * w)),
                -1.0 / 18.0, 1.0 / 6.0, -1.75, 0.5)
    q45 = q_set(14.0 * w + math.sqrt(w) * (-1.625 + 4.5 * math.exp(-5.0 * w)),
                -1.0 / 12.0, 0.25, -2.0, 0.525)
    q50 = q_set(12.5 * w + math.sqrt(w) * (-1.0 + 5.0 * math.exp(-5.0 * w)),
                -0.125, 0.375, -2.25, 0.541)
    v35 = ((w * w + 2.0 * w + 1.0) / (3.125 * w * w + 4.0 * w + 1.0), 0.447)
    v40 = ((w * w + 54.0 * w + 50.0) / (30.0 / 11.0 * w * w + 134.0 * w + 50.0),
           0.391)
    v45 = ((w * w + 43.0 * w + 38.0) / (7.0 / 3.0 * w * w + 92.5 * w + 38.0),
           0.348)
    v50 = ((w + 13.0 / 14.0) / (2.0 * w + 13.0 / 14.0), 0.313)
    if kap < 4.0:
        out["rho_frac"] = (kap - 3.5) / 0.5
        out["rho_q_low"], out["rho_q_high"] = q35, q40
        out["rho_v_low"], out["rho_v_high"] = v35, v40
    elif kap < 4.5:
        out["rho_frac"] = (kap - 4.0) / 0.5
        out["rho_q_low"], out["rho_q_high"] = q40, q45
        out["rho_v_low"], out["rho_v_high"] = v40, v45
    else:
        out["rho_frac"] = (kap - 4.5) / 0.5
        out["rho_q_low"], out["rho_q_high"] = q45, q50
        out["rho_v_low"], out["rho_v_high"] = v45, v50
    return out


@functools.lru_cache(maxsize=32)
def population_constants(plasma: PlasmaParams, polarized: bool):
    """(powerlaw_constants or None, kappa_constants or None) of the
    populations ``plasma`` mixes in, once per configuration and route."""
    return (powerlaw_constants(plasma) if plasma.power_frac != 0.0 else None,
            kappa_constants(plasma, polarized=polarized)
            if plasma.kappa_frac != 0.0 else None)


def _nu_c(state):
    return Physics.e * state["bb_cgs"][..., None] \
        / (2.0 * Math.pi * Physics.m_e * Physics.c)


def _sign(cos_b):
    return torch.where(cos_b >= 0.0, 1.0, -1.0)


def powerlaw_coefficients(nu_cgs, nu0: float, state, sin_theta_b,
                          cos_theta_b, plasma: PlasmaParams, consts: dict,
                          polarized: bool) -> dict:
    """The power-law population's coefficients (M 28-29, 38-42;
    simulation_coefficients.cpp:558-605), scaled as the thermal ones.

    float64 keeps the reference's literal expressions, with their inf and
    NaN at exactly degenerate cells (sin theta_B = 0, B = 0), which flag
    the sample bad and poison the pixel as the reference's NaNs do.
    float32 takes the hardened forms: a 1e-12 floor on nu_c sin, sin
    clamped into [1e-6, 1 - 1e-7] in its fractional powers, and the
    0 * inf products of j_V and rho cancelled algebraically."""
    out = {}
    n_e = state["n_e_cgs"][..., None]
    sin_b = sin_theta_b[..., None]
    frac = plasma.power_frac
    pp = plasma.power_p
    nu_c = _nu_c(state)
    f64 = nu_cgs.dtype == torch.float64
    ncs = torch.clamp(nu_c * sin_b, min=1e-300 if f64 else 1e-12)
    sin_c = sin_b if f64 else torch.clamp(sin_b, 1e-6, 1.0 - 1e-7)
    ratio = nu_cgs / ncs

    var_a = torch.pow(ratio, -(pp - 1.0) / 2.0)
    coeff_j = frac * n_e * nu_c * (nu0 / nu_cgs) ** 2 * consts["jj"] \
        * sin_b * var_a
    out["j_i"] = coeff_j
    if polarized:
        cos_b = cos_theta_b[..., None]
        out["j_q"] = coeff_j * consts["jj_q"]
        if f64:
            var_b = cos_b / sin_b
            var_c = 1.0 / torch.sqrt(nu_cgs / (3.0 * nu_c * sin_b))
            out["j_v"] = coeff_j * consts["jj_v"] * var_b * var_c
        else:
            # (cos / sin) sqrt(3 nu_c sin / nu) with sin cancelled: the
            # literal product is 0 * inf at sin = 0
            arg = 3.0 * ncs / nu_cgs
            root = torch.where(arg > 1e-30,
                               torch.sqrt(torch.where(arg > 1e-30, arg, 1.0)),
                               0.0)
            coeff_j_nosin = frac * n_e * nu_c * (nu0 / nu_cgs) ** 2 \
                * consts["jj"] * var_a
            out["j_v"] = coeff_j_nosin * consts["jj_v"] * cos_b * root

    # absorptivities, true invariant CGS: e^2 / (m_e c) times n_e
    ka = Physics.e * Physics.e / (Physics.m_e * Physics.c)
    var_a2 = torch.pow(ratio, -(pp + 2.0) / 2.0)
    coeff_a = frac * n_e * ka * consts["aa"] * var_a2
    out["alpha_i"] = coeff_a
    if polarized:
        var_b2 = torch.pow(torch.pow(sin_c, -1.92) * 3.1 - 3.1, 0.512)
        var_c2 = 1.0 / torch.sqrt(ratio)
        out["alpha_q"] = coeff_a * consts["aa_q"]
        out["alpha_v"] = coeff_a * consts["aa_v"] * var_b2 * var_c2 \
            * _sign(cos_b)
        if f64:
            # rotativities (M 40-42), literal forms
            var_a3 = n_e * ka * nu_cgs / (nu_c * sin_b)
            var_b3 = nu_c * sin_b / nu_cgs
            var_c3 = var_b3 * var_b3
            var_d3 = var_c3 * var_b3
            var_e3 = 1.0 - torch.pow(
                2.0 * nu_c * plasma.gamma_min ** 2 * sin_b / (3.0 * nu_cgs),
                pp / 2.0 - 1.0)
            var_f3 = cos_b / sin_b
            coeff_r = frac * consts["rho"] * var_a3
            out["rho_q"] = coeff_r * consts["rho_q"] * var_d3 * var_e3
            out["rho_v"] = coeff_r * consts["rho_v"] * var_c3 * var_f3
        else:
            # the 1 / (nu_c sin) of var_a3 cancelled into var_d3 and
            # var_c3 (the literal products are inf * 0 at B = 0)
            var_e3 = 1.0 - torch.pow(torch.clamp(
                2.0 * nu_c * plasma.gamma_min ** 2 * sin_b / (3.0 * nu_cgs),
                min=1e-20), pp / 2.0 - 1.0)
            coeff_r = frac * consts["rho"] * n_e * ka
            out["rho_q"] = coeff_r * consts["rho_q"] \
                * (ncs / nu_cgs) ** 2 * var_e3
            out["rho_v"] = coeff_r * consts["rho_v"] * nu_c * cos_b / nu_cgs
    return out


def _bridge(low, high, x: float):
    """The bridge (low^-x + high^-x)^(-1/x) between the low- and
    high-frequency forms, as m (1 + (m / M)^x)^(-1/x) with m, M the
    smaller and the larger: the literal low^-x is inf at low = 0; the
    ratio stays in [0, 1]. The floor on M follows the type."""
    m = torch.minimum(low, high)
    mm = torch.maximum(low, high)
    tiny = 1e-150 if m.dtype == torch.float64 else 1e-18
    ok = mm > tiny
    r = torch.where(ok, m, 0.0) / torch.where(ok, mm, 1.0)
    pos = r > 1e-30
    rx = torch.where(pos, torch.pow(torch.where(pos, r, 1.0), x), 0.0)
    return m * torch.pow(1.0 + rx, -1.0 / x)


def kappa_coefficients(nu_cgs, nu0: float, state, sin_theta_b, cos_theta_b,
                       sin2_theta_b, plasma: PlasmaParams, consts: dict,
                       polarized: bool) -> dict:
    """The kappa population's coefficients (M 28-29, 43-54;
    simulation_coefficients.cpp:607-698). float64 keeps the literal
    forms; float32 floors nu_kappa at 1e-12 and clamps sin into
    [1e-6, 1 - 1e-7] in its fractional powers."""
    out = {}
    n_e = state["n_e_cgs"][..., None]
    sin_b = sin_theta_b[..., None]
    frac = plasma.kappa_frac
    kap, w = plasma.kappa, plasma.w
    nu_c = _nu_c(state)
    nu_kappa = nu_c * w * w * kap * kap * sin_b
    f64 = nu_cgs.dtype == torch.float64
    xx = nu_cgs / torch.clamp(nu_kappa, min=1e-300 if f64 else 1e-12)
    sin_cl = sin_b if f64 else torch.clamp(sin_b, 1e-6, 1.0 - 1e-7)

    # emissivities, scaled by e^2 nu0^2 / c
    var_a = frac * n_e * nu_c * (nu0 / nu_cgs) ** 2
    var_b = cbrt(xx) * sin_b
    var_c = torch.pow(xx, -(kap - 2.0) / 2.0) * sin_b
    c_low = consts["jj_low"] * var_a * var_b
    c_high = consts["jj_high"] * var_a * var_c
    out["j_i"] = _bridge(c_low, c_high, consts["jj_x_i"])
    if polarized:
        cos_b = cos_theta_b[..., None]
        var_d = torch.pow(torch.pow(sin_cl, -2.4) - 1.0, 0.48)
        var_e = torch.pow(xx, -0.35)
        var_f = torch.pow(torch.pow(sin_cl, -2.5) - 1.0, 0.44)
        var_g = 1.0 / torch.sqrt(xx)
        out["j_q"] = -_bridge(c_low * consts["jj_low_q"],
                              c_high * consts["jj_high_q"], consts["jj_x_q"])
        out["j_v"] = _bridge(c_low * consts["jj_low_v"] * var_d * var_e,
                             c_high * consts["jj_high_v"] * var_f * var_g,
                             consts["jj_x_v"]) * _sign(cos_b)

    # absorptivities (true CGS)
    ka = Physics.e * Physics.e / (Physics.m_e * Physics.c)
    var_a2 = frac * n_e * ka
    a_low = consts["aa_low"] * var_a2 * torch.pow(xx, -2.0 / 3.0)
    a_high = consts["aa_high"] * var_a2 * torch.pow(xx, -(1.0 + kap) / 2.0)
    out["alpha_i"] = _bridge(a_low, a_high * consts["aa_high_i"],
                             consts["aa_x_i"])
    if polarized:
        sin2_b = sin2_theta_b[..., None]
        var_d2 = torch.pow(torch.pow(sin_cl, -2.28) - 1.0, 0.446)
        var_e2 = torch.pow(xx, -0.35)
        var_f2 = torch.sqrt(torch.pow(sin_cl, -2.05) - 1.0)
        var_g2 = 1.0 / torch.sqrt(xx)
        out["alpha_q"] = -_bridge(a_low * consts["aa_low_q"],
                                  a_high * consts["aa_high_q"],
                                  consts["aa_x_q"])
        out["alpha_v"] = _bridge(a_low * consts["aa_low_v"] * var_d2 * var_e2,
                                 a_high * consts["aa_high_v"] * var_f2 * var_g2,
                                 consts["aa_x_v"]) * _sign(cos_b)

        # rotativities (M 51-54), blended between the kappa brackets
        var_a3 = -frac * n_e * ka * nu_c ** 2 * sin2_b / (nu_cgs * nu_cgs)
        var_b3 = frac * 2.0 * n_e * ka * nu_c * cos_b / nu_cgs
        var_c3 = 1.0 / torch.sqrt(xx)

        def rho_q_term(q):
            return var_a3 * q["a"] * (
                1.0 - torch.exp(q["b"] * torch.pow(xx, 0.84))
                - torch.sin(q["c"] * xx)
                * torch.exp(q["d"] * torch.pow(xx, q["e"])))

        def rho_v_term(v):
            a, bb = v
            return consts["rho_v"] * var_b3 * a \
                * (1.0 - 0.17 * torch.log1p(bb * var_c3))

        fr = consts["rho_frac"]
        out["rho_q"] = (1.0 - fr) * rho_q_term(consts["rho_q_low"]) \
            + fr * rho_q_term(consts["rho_q_high"])
        out["rho_v"] = (1.0 - fr) * rho_v_term(consts["rho_v_low"]) \
            + fr * rho_v_term(consts["rho_v_high"])
    return out


COEFFICIENT_KEYS = ("j_i", "j_q", "j_v", "alpha_i", "alpha_q", "alpha_v",
                    "rho_q", "rho_v")


def all_coefficients(nu_cgs, nu0: float, state, sin_theta_b,
                     plasma: PlasmaParams, *, cos_theta_b=None,
                     sin2_theta_b=None, polarized: bool = False):
    """The thermal, power-law and kappa populations summed in that order,
    each only where its fraction is not 0 (the reference accumulates
    into shared arrays), with ``population_constants(plasma,
    polarized)``. Returns what ``thermal_coefficients`` returns: (j_i,
    alpha_i), or with ``polarized`` the dict of all eight, each (B, F)."""
    pl_consts, kp_consts = population_constants(plasma, polarized)
    keys = COEFFICIENT_KEYS if polarized else ("j_i", "alpha_i")
    total = None
    if plasma.thermal_frac != 0.0:
        total = thermal_coefficients(
            nu_cgs, nu0, state, sin_theta_b, plasma, cos_theta_b=cos_theta_b,
            sin2_theta_b=sin2_theta_b, polarized=polarized)
        if not polarized:
            total = dict(zip(keys, total))
    parts = []
    if plasma.power_frac != 0.0:
        parts.append(powerlaw_coefficients(
            nu_cgs, nu0, state, sin_theta_b, cos_theta_b, plasma, pl_consts,
            polarized))
    if plasma.kappa_frac != 0.0:
        parts.append(kappa_coefficients(
            nu_cgs, nu0, state, sin_theta_b, cos_theta_b, sin2_theta_b,
            plasma, kp_consts, polarized))
    for part in parts:
        total = part if total is None else {k: total[k] + part[k]
                                            for k in keys}
    if total is None:
        total = {k: torch.zeros_like(nu_cgs) for k in keys}
    if polarized:
        return total
    return total["j_i"], total["alpha_i"]
