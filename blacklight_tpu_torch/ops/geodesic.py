"""Geodesic integration parameters, the Dormand-Prince tableau and the
lock-step ray loop of the fused kernels' plain versions.

Port of the parameter half of ``blacklight_tpu/ops/geodesic.py:44-98``.
The step loop itself runs inside the fused kernels (``csrc/trace.cuh``
on the card); ``trace_reference`` is the same loop in plain torch ops,
shared by ``ops/formula_kernel.render_formula_reference`` and
``ops/simulation_kernel.render_simulation_reference``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from blacklight_tpu.constants import RayIntegrator, RayTerminate
from blacklight_tpu_torch.ops.geometry import (
    geodesic_rhs_c,
    radius_c,
    renormalize_factor_c,
)

# Dormand-Prince RK5(4)7M coefficients (1980 JCoAM 6 19), as in the
# reference geodesics.cpp:42-72. csrc/kerr.cuh holds the same table; the
# tests check the two against each other.
DP_A = (
    (),
    (1.0 / 5.0,),
    (3.0 / 40.0, 9.0 / 40.0),
    (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
    (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
    (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
     -5103.0 / 18656.0),
    (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
     11.0 / 84.0),
)
DP_B5 = (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0,
         -2187.0 / 6784.0, 11.0 / 84.0, 0.0)
DP_B4 = (5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
         -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0)
DP_B4M = (6025192743.0 / 30085553152.0, 0.0, 51252292925.0 / 65400821598.0,
          -2691868925.0 / 45128329728.0, 187940372067.0 / 1594534317056.0,
          -1776094331.0 / 19743644256.0, 11237099.0 / 235043384.0)
DP_ERR_POWER = 0.2
DP_ERR_FACTOR = 0.9
DP_MIN_FACTOR = 0.2
DP_MAX_FACTOR = 10.0


@dataclasses.dataclass(frozen=True)
class GeodesicParams:
    """Static integration parameters (subset of Config, all Python scalars)."""

    integrator: RayIntegrator
    bh_m: float
    bh_a: float
    ray_flat: bool
    ray_step: float
    ray_max_steps: int
    r_terminate: float
    camera_r: float
    r_horizon: float
    ray_tol_abs: float = 1.0e-8
    ray_tol_rel: float = 1.0e-8
    ray_max_retries: int = 20


def horizon_radius(bh_m: float, bh_a: float) -> float:
    """r_+ = M + sqrt(M^2 - a^2) (geodesic_integrator.cpp:117)."""
    return bh_m + math.sqrt(bh_m * bh_m - bh_a * bh_a)


def terminate_radius(ray_terminate, ray_factor: float, bh_m: float,
                     bh_a: float) -> float:
    """Inner termination radius (geodesic_integrator.cpp:118-123)."""
    r_h = horizon_radius(bh_m, bh_a)
    if ray_terminate == RayTerminate.photon:
        return 2.0 * bh_m * (1.0 + math.cos(
            2.0 / 3.0 * math.acos(-abs(bh_a) / bh_m)))
    if ray_terminate == RayTerminate.multiplicative:
        return r_h * ray_factor
    return r_h + ray_factor


# Index order of the geodesic block that opens every fused kernel's float64
# parameter vector: the enum GeodesicParam in csrc/trace.cuh with its "G_"
# prefix dropped.
GEODESIC_PARAM_NAMES = (
    "SPIN", "A2", "TWO_SPIN", "TWO_A2", "THREE_A2", "TWO_MASS",
    "FLAT", "RAY_STEP", "CAMERA_R", "R_TERMINATE", "R_HORIZON", "TOL_ABS",
    "TOL_REL", "MAX_STEPS", "MAX_RETRIES", "FALLBACK_NAN",
)


def geodesic_param_values(params: GeodesicParams, fallback_nan: bool) -> dict:
    """The geodesic block by name, every derived constant folded in
    float64 (the kernel rounds each once to its working type, as JAX
    rounds a Python scalar)."""
    spin, mass = params.bh_a, params.bh_m
    return {
        "SPIN": spin, "A2": spin * spin, "TWO_SPIN": 2.0 * spin,
        "TWO_A2": 2.0 * (spin * spin), "THREE_A2": 3.0 * (spin * spin),
        "TWO_MASS": 2.0 * mass, "FLAT": params.ray_flat,
        "RAY_STEP": params.ray_step, "CAMERA_R": params.camera_r,
        "R_TERMINATE": params.r_terminate, "R_HORIZON": params.r_horizon,
        "TOL_ABS": params.ray_tol_abs, "TOL_REL": params.ray_tol_rel,
        "MAX_STEPS": params.ray_max_steps,
        "MAX_RETRIES": params.ray_max_retries,
        "FALLBACK_NAN": fallback_nan,
    }


def pack_params(names, values: dict) -> list:
    """``values`` as a list in ``names`` order; the two must hold the same
    names."""
    if set(values) != set(names):
        raise AssertionError(sorted(set(values) ^ set(names)))
    return [float(values[name]) for name in names]


def trace_reference(positions, directions, params: GeodesicParams,
                    integrator: str, on_sample):
    """Integrate a ray bundle in lock step and hand every step's stored
    sample to ``on_sample``: the loop of the fused kernels, in plain
    torch ops over (B,) tensors.

    Every ray advances together, as in the Pallas block: masks select the
    state updates, dead rays park at a benign state, and the loop runs
    while any ray is alive and n < max_steps. The JAX kernel's forms are
    kept, where-guards included.

    on_sample(valid, x, k, h) is called once per step with the (B,) mask
    of rays whose sample counts, the sample position x (x^0..x^3), its
    null-renormalized covariant momentum k (p_0..p_3) and the signed
    affine step h; it sees every ray, valid or not.

    Returns (flag (B,) bool, n_samples (B,) int32).
    """
    spin, mass, flat = params.bh_a, params.bh_m, params.ray_flat
    max_steps = params.ray_max_steps
    dp = integrator == "dp"
    x0, x1, x2, x3 = positions.unbind(-1)
    p0, p1, p2, p3 = directions.unbind(-1)
    zero = torch.zeros_like(x0)
    false = torch.zeros_like(x0, dtype=torch.bool)
    izero = torch.zeros_like(x0, dtype=torch.int32)

    def rhs(y, with_distance=False):
        return geodesic_rhs_c(y[1], y[2], y[3], p0, y[4], y[5], y[6], spin,
                              mass, flat=flat, with_distance=with_distance)

    def renorm(y):
        return renormalize_factor_c(y[1], y[2], y[3], p0, y[4], y[5], y[6],
                                    spin, mass, flat=flat)

    def add_stage(base, weights, k, h):
        out = []
        for ci in range(7):
            acc = None
            for q, w in enumerate(weights):
                if w == 0.0:
                    continue
                term = (w * h) * k[q][ci]
                acc = term if acc is None else acc + term
            out.append(base[ci] if acc is None else base[ci] + acc)
        return out

    y = [x0, x1, x2, x3, p1, p2, p3]
    h_state = -params.ray_step * radius_c(x1, x2, x3, spin)
    alive = ~false
    trunc, flag, prev_fail = false, false, false
    r_mid_prev = zero
    n_samp, num_retry = izero, izero

    n = 0
    while n < max_steps and bool(alive.any()):
        r = radius_c(y[1], y[2], y[3], spin)
        if dp:
            k = [None] * 7
            k[0] = rhs(y, with_distance=True)
            ds_dlam = torch.abs(k[0][7]) + 1e-30
            h_cap = params.ray_step * r / ds_dlam
            h = -torch.minimum(torch.abs(h_state), h_cap)
            for i in range(1, 7):
                k[i] = rhs(add_stage(y, DP_A[i], k, h))
            y_end = add_stage(y, DP_B5, k, h)
            y4 = add_stage(y, DP_B4, k, h)
            y_mid = add_stage(y, DP_B4M, k, h)

            err = zero
            for ci in range(7):
                ya = torch.maximum(torch.abs(y[ci]), torch.abs(y_end[ci]))
                sc = params.ray_tol_abs + params.ray_tol_rel * ya
                err = torch.maximum(err, torch.abs(y_end[ci] - y4[ci]) / sc)
            accept = err <= 1.0
            err_safe = torch.clamp(err, min=1e-30)
            fac_ideal = DP_ERR_FACTOR * err_safe ** (-DP_ERR_POWER)
            fac_rej = torch.clamp(
                torch.where(torch.isfinite(err), fac_ideal, DP_MIN_FACTOR),
                min=DP_MIN_FACTOR)
            fac_acc = torch.clamp(fac_ideal, DP_MIN_FACTOR, DP_MAX_FACTOR)
            fac_acc = torch.where(err == 0.0, DP_MAX_FACTOR, fac_acc)
            fac_acc = torch.where(prev_fail, torch.clamp(fac_acc, max=1.0),
                                  fac_acc)
            h_next = h * torch.where(accept, fac_acc, fac_rej)
            retry = torch.where(accept, 0, num_retry + 1)
            retry_exceeded = retry > params.ray_max_retries
        else:
            h = torch.where(alive, -params.ray_step * (r - params.r_horizon),
                            0.0)
            k1 = rhs(y)
            if integrator == "rk4":
                k2 = rhs([y[c] + (0.5 * h) * k1[c] for c in range(7)])
                k3 = rhs([y[c] + (0.5 * h) * k2[c] for c in range(7)])
                k4 = rhs([y[c] + (1.0 * h) * k3[c] for c in range(7)])
                y_end = [y[c] + h * (k1[c] * (1.0 / 6.0) + k2[c] * (1.0 / 3.0)
                                     + k3[c] * (1.0 / 3.0)
                                     + k4[c] * (1.0 / 6.0))
                         for c in range(7)]
                y_mid = [0.5 * (y[c] + y_end[c]) for c in range(7)]
            else:  # rk2 (Heun); the sample is y + h/2 k1
                k2 = rhs([y[c] + (1.0 * h) * k1[c] for c in range(7)])
                y_end = [y[c] + 0.5 * h * (k1[c] + k2[c]) for c in range(7)]
                y_mid = [y[c] + (0.5 * h) * k1[c] for c in range(7)]
            accept = ~false
            retry_exceeded = false

        fac = renorm(y_end)
        r_new = radius_c(y_end[1], y_end[2], y_end[3], spin)
        facm = renorm(y_mid)
        r_mid = radius_c(y_mid[1], y_mid[2], y_mid[3], spin)

        trunc_now = (n_samp > 0) & (
            ((r_mid > params.camera_r) & (r_mid > r_mid_prev))
            | (r_mid < params.r_terminate))
        trunc = trunc | (accept & trunc_now)
        valid = alive & accept & ~trunc & ~retry_exceeded
        terminate = ((r_new > params.camera_r) & (r_new > r)) \
            | (r_new < params.r_terminate)
        flag = flag | (alive & retry_exceeded) \
            | (alive & accept & ~terminate & (n == max_steps - 1))
        alive_new = alive & ~(accept & terminate) & ~retry_exceeded

        on_sample(valid, y_mid[:4],
                  (p0, y_mid[4] * facm, y_mid[5] * facm, y_mid[6] * facm), h)

        step = alive & accept
        park = ~alive_new
        stepped = [y_end[0], y_end[1], y_end[2], y_end[3],
                   y_end[4] * fac, y_end[5] * fac, y_end[6] * fac]
        parked = (0.0, 1.0e3, 0.0, 0.0, 1.0, 0.0, 0.0)
        y = [torch.where(park, parked[c], torch.where(step, stepped[c], y[c]))
             for c in range(7)]
        if dp:
            h_state = torch.where(alive, h_next, h_state)
            num_retry = torch.where(alive, retry, num_retry)
            prev_fail = (alive & ~accept) | (~alive & prev_fail)
        r_mid_prev = torch.where(valid, r_mid, r_mid_prev)
        n_samp = n_samp + valid.to(torch.int32)
        alive = alive_new
        n += 1
    return flag, n_samp
