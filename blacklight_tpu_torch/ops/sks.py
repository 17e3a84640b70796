"""Spherical Kerr-Schild (SKS) helpers on tensors: conversion, metric
scalars, Jacobian.

Port of ``blacklight_tpu/ops/sks.py`` (the reference's
radiation_geometry.cpp: ConvertFromCKS :37-57, CoordinateJacobian
:69-126, the SKS metric :459-491 and :541-573), keeping its operand order
so that the two packages round alike. ``spin`` and ``mass`` are Python
floats.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def cks_to_sks(x, y, z, spin):
    """CKS -> SKS (r, theta, phi) with phi in [0, 2 pi)."""
    a2 = spin * spin
    rr2 = x * x + y * y + z * z
    r2 = 0.5 * (rr2 - a2 + torch.hypot(rr2 - a2, 2.0 * spin * z))
    r = torch.sqrt(r2)
    th = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    ph = torch.atan2(y, x) - torch.atan(spin / r)
    two_pi = 2.0 * math.pi
    ph = torch.where(ph < 0.0, ph + two_pi, ph)
    ph = torch.where(ph >= two_pi, ph - two_pi, ph)
    return r, th, ph


@dataclasses.dataclass(frozen=True)
class SKSMetric:
    """Nonzero SKS metric components at CKS positions, all (B,)-shaped.

    Covariant: g_tt, g_tr, g_tph, g_rr, g_rph, g_thth, g_phph
    Contravariant: gi_tt, gi_tr, gi_rr, gi_rph, gi_thth, gi_phph
    """

    g_tt: torch.Tensor
    g_tr: torch.Tensor
    g_tph: torch.Tensor
    g_rr: torch.Tensor
    g_rph: torch.Tensor
    g_thth: torch.Tensor
    g_phph: torch.Tensor
    gi_tt: torch.Tensor
    gi_tr: torch.Tensor
    gi_rr: torch.Tensor
    gi_rph: torch.Tensor
    gi_thth: torch.Tensor
    gi_phph: torch.Tensor


def sks_metric(x, y, z, spin, mass=1.0) -> SKSMetric:
    """SKS metric scalars evaluated from CKS coordinates."""
    a2 = spin * spin
    rr2 = x * x + y * y + z * z
    r2 = 0.5 * (rr2 - a2 + torch.hypot(rr2 - a2, 2.0 * spin * z))
    r = torch.sqrt(r2)
    cth = z / r
    cth2 = cth * cth
    sth2 = 1.0 - cth2
    sigma = r2 + a2 * cth2
    delta = r2 - 2.0 * mass * r + a2
    w = 2.0 * mass * r / sigma
    return SKSMetric(
        g_tt=-(1.0 - w),
        g_tr=w,
        g_tph=-w * spin * sth2,
        g_rr=1.0 + w,
        g_rph=-(1.0 + w) * spin * sth2,
        g_thth=sigma,
        g_phph=(r2 + a2 + w * a2 * sth2) * sth2,
        gi_tt=-(1.0 + w),
        gi_tr=w,
        gi_rr=delta / sigma,
        gi_rph=spin / sigma,
        gi_thth=1.0 / sigma,
        gi_phph=1.0 / (sigma * sth2),
    )


def sks_to_cks_vector(vr, vth, vph, x, y, z, spin):
    """Spatial contravariant vector components SKS -> CKS; the time
    component is unchanged."""
    a2 = spin * spin
    rr2 = x * x + y * y + z * z
    r2 = 0.5 * (rr2 - a2 + torch.hypot(rr2 - a2, 2.0 * spin * z))
    r = torch.sqrt(r2)
    cth = z / r
    sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
    ph = torch.atan2(y, x) - torch.atan(spin / r)
    sph = torch.sin(ph)
    cph = torch.cos(ph)
    vx = sth * cph * vr + cth * (r * cph - spin * sph) * vth \
        + sth * (-r * sph - spin * cph) * vph
    vy = sth * sph * vr + cth * (r * sph + spin * cph) * vth \
        + sth * (r * cph - spin * sph) * vph
    vz = cth * vr - r * sth * vth
    return vx, vy, vz


def normal_frame_velocity(m: SKSMetric, uu1, uu2, uu3):
    """Normal-frame 3-velocity -> contravariant 4-velocity in SKS
    (simulation_coefficients.cpp:297-313)."""
    uu0 = torch.sqrt(1.0 + m.g_rr * uu1 * uu1 + 2.0 * m.g_rph * uu1 * uu3
                     + m.g_thth * uu2 * uu2 + m.g_phph * uu3 * uu3)
    lapse = 1.0 / torch.sqrt(-m.gi_tt)
    shift1 = -m.gi_tr / m.gi_tt
    shift3 = -m.gi_rph / m.gi_tt
    ut = uu0 / lapse
    ur = uu1 - shift1 * uu0 / lapse
    uth = uu2
    uph = uu3 - shift3 * uu0 / lapse
    return ut, ur, uth, uph


def lower_sks(m: SKSMetric, vt, vr, vth, vph):
    """Lower an SKS 4-vector with the sparse covariant metric."""
    lt = m.g_tt * vt + m.g_tr * vr + m.g_tph * vph
    lr = m.g_tr * vt + m.g_rr * vr + m.g_rph * vph
    lth = m.g_thth * vth
    lph = m.g_tph * vt + m.g_rph * vr + m.g_phph * vph
    return lt, lr, lth, lph
