"""Unpolarized radiative transfer with every image plane, on tensors.

Port of ``blacklight_tpu/transfer/unpolarized.py`` (``DELTA_TAU_MAX``,
``ImageOptions``, ``integrate_unpolarized`` and its final transforms,
:40-419; the reference is unpolarized.cpp:31-221): the route of the
auxiliary image planes (time, length, lambda, emission, tau, the
cell-value averages, crossings) and of ``image_light = false``, which the
JAX package renders on its XLA path and never in a Pallas kernel. It runs
in torch ops on the rays' device, a CPU or a CUDA one alike, streamed
through ``ops/geodesic.trace_compacted`` (the kernels' plain lock-step
loop, each ray's steps bit for bit, but finished rays leave the bundle
and on the card each step is replayed from a CUDA graph): every step's
samples are consumed as they are produced and nothing is stored per
step. False-color renderings (``transfer/rendering.Renderer``) ride the
same samples.

The transfer sum is accumulated camera to far end,

    I = sum_k S_k (1 - e^{-dtau_k}) e^{-tau_<k},

which is the reference's far-to-near recurrence reordered; a sample with
dtau > DELTA_TAU_MAX contributes S e^{-tau_<k} and sets tau to inf, so
everything farther is discarded (unpolarized.cpp:96-110). ``light_update``
is that step; the simulation kernel's plain version
(``ops/simulation_kernel.transfer_update``) calls it too.

Not ported: stored-sample input (ROADMAP A.8) and the wavefront sampler
(not ported, by design).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from blacklight_tpu_torch.constants import NUM_CELL_VALUES, Physics
from blacklight_tpu_torch.ops import geodesic, geometry

DELTA_TAU_MAX = 100.0  # reference radiation_integrator.hpp:191

# The planes of ImageOptions besides light, in config order.
AUX_PLANES = ("time", "length", "lam", "emission", "tau", "lambda_ave",
              "emission_ave", "tau_int", "crossings")


@dataclasses.dataclass(frozen=True)
class ImageOptions:
    """Which image quantities to produce (reference image_* flags)."""

    light: bool = True
    time: bool = False
    length: bool = False
    lam: bool = False
    emission: bool = False
    tau: bool = False
    lambda_ave: bool = False
    emission_ave: bool = False
    tau_int: bool = False
    crossings: bool = False
    fallback_nan: bool = True
    # Slow light (ROADMAP B.6): the per-pixel least and greatest sample
    # coordinate times, as "_t_min" and "_t_max".
    track_sample_times: bool = False

    @staticmethod
    def from_config(cfg) -> "ImageOptions":
        return ImageOptions(
            light=cfg.require("image_light"),
            time=bool(cfg.image_time),
            length=bool(cfg.image_length),
            lam=bool(cfg.image_lambda),
            emission=bool(cfg.image_emission),
            tau=bool(cfg.image_tau),
            lambda_ave=bool(cfg.image_lambda_ave),
            emission_ave=bool(cfg.image_emission_ave),
            tau_int=bool(cfg.image_tau_int),
            crossings=bool(cfg.image_crossings),
            fallback_nan=cfg.require("fallback_nan"),
        )

    @property
    def aux(self) -> bool:
        """Whether any plane besides light is asked for."""
        return any(getattr(self, name) for name in AUX_PLANES)

    @property
    def cells(self) -> bool:
        """Whether a cell-value plane is asked for (they need a cell_fn)."""
        return self.lambda_ave or self.emission_ave or self.tau_int


def x_unit(mass_msun: float) -> float:
    """The length unit GM/c^2 in cm."""
    return Physics.gg_msun * mass_msun / (Physics.c * Physics.c)


def safe_sample(valid, x, k, camera_x):
    """The sample's position (B, 4) and covariant momentum (four (B,)
    components), with invalid samples moved to the camera: they hold dead
    rays' last state (possibly inside the horizon), where the
    coefficients may not be finite; their values are discarded through
    ``valid``. camera_x is a 4-sequence of Python floats."""
    pos = torch.stack([torch.where(valid, x[c], camera_x[c])
                       for c in range(4)], dim=-1)
    kcov = (torch.where(valid, k[0], -1.0), torch.where(valid, k[1], 1.0),
            torch.where(valid, k[2], 0.0), torch.where(valid, k[3], 0.0))
    return pos, kcov


def path_cgs(valid, h, x_unit_cm: float, frequencies, momentum_factors):
    """(delta_lambda (B,), dl_cgs (B, F)): the positive affine step of
    each valid sample (0 elsewhere) and its CGS path increment
    (unpolarized.cpp:75-76)."""
    delta_lambda = -torch.where(valid, h, 0.0)
    dl_cgs = delta_lambda[:, None] * x_unit_cm \
        / (frequencies[None, :] * momentum_factors[:, None])
    return delta_lambda, dl_cgs


def sanitize(j, alpha, cbad):
    """The coefficients with samples the reference would NaN zeroed:
    (j, alpha, bad), bad where ``cbad`` or a coefficient is not finite."""
    bad = cbad | ~(torch.isfinite(j) & torch.isfinite(alpha))
    return torch.where(bad, 0.0, j), torch.where(bad, 0.0, alpha), bad


def light_update(intensity, tau, j, alpha, dl_cgs, vcol):
    """One sample's step of the light recurrence: (intensity, tau) after
    it, each (B, F); ``vcol`` (B, 1) marks valid samples."""
    pos_alpha = alpha > 0.0
    ss = j / torch.where(pos_alpha, alpha, 1.0)
    delta_tau = alpha * dl_cgs
    atten = torch.exp(-tau)
    thin = delta_tau <= DELTA_TAU_MAX
    contrib = torch.where(pos_alpha,
                          torch.where(thin, ss * -torch.expm1(-delta_tau),
                                      ss),
                          j * dl_cgs)
    intensity = intensity + torch.where(vcol, contrib * atten, 0.0)
    dtau_eff = torch.where(pos_alpha,
                           torch.where(thin, delta_tau, math.inf), 0.0)
    return intensity, tau + torch.where(vcol, dtau_eff, 0.0)


def proper_length(pos, kcov, spin: float, mass: float, flat: bool):
    """dl2 (B,): the squared spatial proper length per unit affine step
    of the momentum ``kcov`` (B, 4) at ``pos`` (B, 4), in the frame
    normal to the time slices (unpolarized.cpp:117-129)."""
    g_cov, g_con = geometry.gcov_gcon(pos[:, 1:], spin, mass, flat=flat)
    q = (torch.einsum("...am,...m->...a", g_con[:, 1:, :], kcov)
         - g_con[:, 0, 1:] * (torch.einsum("...m,...m->...",
                                           g_con[:, 0, :], kcov)
                              / g_con[:, 0, 0])[:, None])
    return torch.einsum("...ab,...a,...b->...", g_cov[:, 1:, 1:], q, q)


def plane_sign(camera_x, x1, x2, x3):
    """(B,) which side of the plane through the hole normal to the camera
    each position (x1, x2, x3) lies on (image_crossings)."""
    return (camera_x[1] * x1 + camera_x[2] * x2 + camera_x[3] * x3) > 0.0


def emission_scale(log_j_scale: float, dtype, device):
    """exp(log_j_scale) in ``dtype``: the unit of the scaled j."""
    return torch.exp(torch.tensor(log_j_scale, dtype=dtype, device=device))


def integrate_unpolarized(positions, directions, momentum_factors,
                          frequencies, *, params: geodesic.GeodesicParams,
                          integrator: str, coeff_fn: Callable,
                          opts: ImageOptions, mass_msun: float, camera_x,
                          cell_fn: Optional[Callable] = None,
                          log_j_scale: float = 0.0, render=None) -> dict:
    """Geodesics and unpolarized transfer with every image plane over a
    ray bundle, in torch ops on the rays' device.

    positions, directions: (B, 4) camera pixel events and covariant
    momenta; momentum_factors (B,); frequencies (F,) [Hz]; integrator
    "dp", "rk4" or "rk2"; camera_x a 4-sequence of Python floats (the
    crossings plane and the point invalid samples are evaluated at).

    coeff_fn(pos (B, 4), kcov four (B,) components, momentum_factors (B,))
    -> (j, alpha, bad), each (B, F): the invariant coefficients (j divided
    by exp(log_j_scale)), zero where cut, and the samples the reference
    would NaN; its rays are the bundle's rays that are still traced
    (``geodesic.trace_compacted``), whose momentum factors it is given.
    cell_fn(pos, kcov) -> (B, NUM_CELL_VALUES) diagnostic values, NaN
    where a sample is cut or invalid; the lambda_ave, emission_ave and
    tau_int planes and ``render`` need it. render: a
    ``transfer/rendering.Renderer``, whose false-color images come from
    the same samples' cell values.

    Returns a dict of tensors: "I_nu" (B, F) with opts.light; "time",
    "length" and "crossings" (B,); "lambda", "emission", "tau" (B, F);
    "lambda_ave", "emission_ave", "tau_int" (B, F, NUM_CELL_VALUES);
    "_t_min", "_t_max" (B,) with track_sample_times; "rendering"
    (B, n_images, 3) with ``render``; "_flags" (B,) bool and "_n_samples"
    (B,) int32.
    """
    b, f = positions.shape[0], frequencies.shape[0]
    dtype, device = positions.dtype, positions.device
    x_cm = x_unit(mass_msun)
    t_unit = x_cm / Physics.c
    spin, mass, flat = params.bh_a, params.bh_m, params.ray_flat
    cam = [float(v) for v in camera_x]

    need_cells = opts.cells or render is not None
    if need_cells and cell_fn is None:
        raise ValueError("cell_fn required for lambda_ave/emission_ave/"
                         "tau_int and rendering")
    need_coeffs = (opts.light or opts.emission or opts.emission_ave
                   or opts.tau or opts.tau_int)

    def zeros(*shape, kind=dtype):
        return torch.zeros(shape, dtype=kind, device=device)

    # the per-ray inputs and accumulators (geodesic.trace_compacted's carry)
    st = {"mom": momentum_factors}
    if need_coeffs:
        # samples whose coefficients the reference would NaN: a flag and
        # a final NaN, so the recurrence itself stays finite
        st["coeff_bad"] = zeros(b, f, kind=torch.bool)
    if opts.light:
        st["I"] = zeros(b, f)
        st["tau_accum"] = zeros(b, f)
    if opts.time:
        st["time"] = zeros(b)
    if opts.length:
        st["length"] = zeros(b)
    if opts.lam or opts.lambda_ave:
        st["lambda"] = zeros(b, f)
    if opts.emission or opts.emission_ave:
        st["emission"] = zeros(b, f)
    if opts.tau:
        st["tau"] = zeros(b, f)
    if opts.lambda_ave:
        st["lambda_ave"] = zeros(b, f, NUM_CELL_VALUES)
    if opts.emission_ave:
        st["emission_ave"] = zeros(b, f, NUM_CELL_VALUES)
    if opts.tau_int:
        st["tau_int"] = zeros(b, f, NUM_CELL_VALUES)
        st["tau_int_tau"] = zeros(b, f)
    if opts.crossings:
        st["crossings"] = zeros(b, kind=torch.int32)
        st["plane_sign"] = zeros(b, kind=torch.bool)
        st["sign_set"] = zeros(b, kind=torch.bool)
    if opts.track_sample_times:
        st["t_min"] = torch.full((b,), math.inf, dtype=dtype, device=device)
        st["t_max"] = torch.full((b,), -math.inf, dtype=dtype, device=device)
    if render is not None:
        st.update(render.start(b, dtype, device))

    def contribution(valid, x, k, h, st):
        pos, kcov = safe_sample(valid, x, k, cam)
        vcol = valid[:, None]
        delta_lambda, dl_cgs = path_cgs(valid, h, x_cm, frequencies,
                                        st["mom"])
        if need_coeffs:
            j, alpha, cbad = coeff_fn(pos, kcov, st["mom"])
            j, alpha, bad = sanitize(j, alpha, cbad)
            st["coeff_bad"] = st["coeff_bad"] | (vcol & bad)
        if need_cells:
            cells = cell_fn(pos, kcov)
        if render is not None:
            render.update(st, valid, cells, render.delta_length(
                valid, pos, torch.stack(kcov, dim=-1), h))
        if opts.cells:
            cells_ok = vcol & ~torch.isnan(cells[:, 0:1])
            cells = torch.where(torch.isnan(cells), 0.0, cells)
        if opts.light:
            st["I"], st["tau_accum"] = light_update(
                st["I"], st["tau_accum"], j, alpha, dl_cgs, vcol)
        if opts.time:
            t_cgs = pos[:, 0] * t_unit
            st["time"] = torch.where(valid, torch.minimum(st["time"], t_cgs),
                                     st["time"])
        if opts.length:
            dl2 = proper_length(pos, torch.stack(kcov, dim=-1), spin, mass,
                                flat)
            st["length"] = st["length"] + torch.where(
                valid, torch.sqrt(torch.clamp(dl2, min=1e-300))
                * delta_lambda * x_cm, 0.0)
        if opts.lam or opts.lambda_ave:
            st["lambda"] = st["lambda"] + valid.to(dtype)[:, None] * dl_cgs
        if opts.emission or opts.emission_ave:
            st["emission"] = st["emission"] + torch.where(vcol, j * dl_cgs,
                                                          0.0)
        if opts.tau:
            st["tau"] = st["tau"] + torch.where(vcol, alpha * dl_cgs, 0.0)
        ok3 = cells_ok[:, :, None] if opts.cells else None
        if opts.lambda_ave:
            st["lambda_ave"] = st["lambda_ave"] + torch.where(
                ok3, cells[:, None, :] * dl_cgs[..., None], 0.0)
        if opts.emission_ave:
            st["emission_ave"] = st["emission_ave"] + torch.where(
                ok3, cells[:, None, :] * (j * dl_cgs)[..., None], 0.0)
        if opts.tau_int:
            delta_tau = alpha * dl_cgs
            thin = delta_tau <= DELTA_TAU_MAX
            atten = torch.exp(-st["tau_int_tau"])
            contrib = torch.where(thin, -torch.expm1(-delta_tau), 1.0)
            st["tau_int"] = st["tau_int"] + torch.where(
                ok3, (contrib * atten)[..., None] * cells[:, None, :], 0.0)
            st["tau_int_tau"] = st["tau_int_tau"] + torch.where(
                cells_ok, torch.where(thin, delta_tau, math.inf), 0.0)
        if opts.crossings:
            sign_new = plane_sign(cam, pos[:, 1], pos[:, 2], pos[:, 3])
            flipped = valid & st["sign_set"] & (sign_new != st["plane_sign"])
            st["crossings"] = st["crossings"] + flipped.to(torch.int32)
            st["plane_sign"] = torch.where(valid, sign_new, st["plane_sign"])
            st["sign_set"] = st["sign_set"] | valid
        if opts.track_sample_times:
            st["t_min"] = torch.where(valid, torch.minimum(st["t_min"], x[0]),
                                      st["t_min"])
            st["t_max"] = torch.where(valid, torch.maximum(st["t_max"], x[0]),
                                      st["t_max"])

    flags, n_samples, st = geodesic.trace_compacted(
        positions, directions, params, integrator, st, contribution)

    # final transforms (unpolarized.cpp:176-209), NaN poisoning flagged
    # rays under fallback_nan and, in the coefficient planes, rays that
    # met a sample the reference would NaN
    out = {"_flags": flags, "_n_samples": n_samples}
    poison = (flags & opts.fallback_nan)[:, None]
    poison_c = poison | st["coeff_bad"] if need_coeffs else poison
    if opts.light:
        # the unit scale with nu^3, in log space: the unit alone
        # (~1e-41) underflows float32
        scale = torch.exp(torch.tensor(log_j_scale, dtype=dtype,
                                       device=device)
                          + 3.0 * torch.log(frequencies[None, :]))
        out["I_nu"] = torch.where(poison_c, math.nan, st["I"] * scale)
    if opts.time:
        out["time"] = st["time"]
    if opts.length:
        out["length"] = st["length"]
    if opts.lam:
        out["lambda"] = st["lambda"]
    if opts.emission:
        out["emission"] = torch.where(
            poison_c, math.nan,
            st["emission"] * emission_scale(log_j_scale, dtype, device))
    if opts.tau:
        out["tau"] = torch.where(poison_c, math.nan, st["tau"])
    if opts.lambda_ave:
        ave = st["lambda_ave"] / st["lambda"][..., None]
        out["lambda_ave"] = torch.where(poison[..., None], 0.0, ave)
    if opts.emission_ave:
        ave = st["emission_ave"] / st["emission"][..., None]
        out["emission_ave"] = torch.where(poison_c[..., None], math.nan, ave)
    if opts.tau_int:
        out["tau_int"] = torch.where(poison_c[..., None], math.nan,
                                     st["tau_int"])
    if opts.crossings:
        out["crossings"] = st["crossings"].to(dtype)
    if opts.track_sample_times:
        out["_t_min"] = st["t_min"]
        out["_t_max"] = st["t_max"]
    if render is not None:
        out["rendering"] = render.finish(st)
    return out
