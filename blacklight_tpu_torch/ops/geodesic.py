"""Geodesic integration parameters and the Dormand-Prince tableau.

Port of the parameter half of ``blacklight_tpu/ops/geodesic.py:44-98``.
The step loops themselves live in the fused kernel
(``ops/formula_kernel.py`` and ``csrc/formula_kernel.cuh``), which is the
only integrator of this package's slice.
"""

from __future__ import annotations

import dataclasses
import math

from blacklight_tpu.constants import RayIntegrator, RayTerminate

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
