"""Cartesian Kerr-Schild (CKS) spacetime geometry on tensors.

Port of ``blacklight_tpu/ops/geometry.py`` (the closed-form CKS metric of
the reference's geodesic_geometry.cpp:19-276). Conventions are the JAX
package's: signature (-,+,+,+), G = c = 1, indices (t, x, y, z), and
g_{munu} = eta_{munu} + f l_mu l_nu with f = 2 M r^3 / (r^4 + a^2 z^2).

The batched forms take ``(..., 3)`` positions and return ``(..., 4, 4)``
metrics; the ``*_c`` forms take one tensor per component, which is the
shape the fused kernel's plain version computes in. ``spin`` and ``mass``
are Python floats. Expressions keep the JAX package's operand order so
that Python folds the same scalar constants before they meet a tensor of
the working dtype. A scalar numerator is written ``(1.0 / t) * s``,
which is how PyTorch evaluates ``s / t``; the CUDA kernel writes the same
form, so the two round alike.
"""

from __future__ import annotations

import torch

__all__ = [
    "radius",
    "ks_scalars",
    "gcov",
    "gcon",
    "ks_derivatives_c",
    "geodesic_rhs_c",
    "renormalize_factor_c",
    "null_momentum_time_component",
    "renormalize_null_momentum",
    "minkowski",
]


def radius(x, spin):
    """Kerr-Schild r(x, y, z): the positive root of
    r^4 - r^2 (|x|^2 - a^2) - a^2 z^2 = 0 (geodesic_geometry.cpp:19-26).

    Args:
      x: (..., 3) CKS spatial coordinates.
      spin: black-hole spin a.
    """
    return radius_c(x[..., 0], x[..., 1], x[..., 2], spin)


def radius_c(x1, x2, x3, spin):
    """Component form of :func:`radius`."""
    a2 = spin * spin
    rr2 = x1 * x1 + x2 * x2 + x3 * x3
    r2 = 0.5 * (rr2 - a2 + torch.hypot(rr2 - a2, 2.0 * spin * x3))
    return torch.sqrt(r2)


def ks_scalars(x, spin, mass=1.0):
    """(r, f, l_lower): r and f are (...,), l_lower the spatial part
    (l_1, l_2, l_3) of the null covector, (..., 3). l_0 = 1 and l^0 = -1
    are handled by the callers."""
    a2 = spin * spin
    rr2 = torch.sum(x * x, dim=-1)
    z = x[..., 2]
    r2 = 0.5 * (rr2 - a2 + torch.hypot(rr2 - a2, 2.0 * spin * z))
    r = torch.sqrt(r2)
    f = 2.0 * mass * r2 * r / (r2 * r2 + a2 * z * z)
    denom = r2 + a2
    lx = (r * x[..., 0] + spin * x[..., 1]) / denom
    ly = (r * x[..., 1] - spin * x[..., 0]) / denom
    lz = z / r
    return r, f, torch.stack([lx, ly, lz], dim=-1)


def minkowski(batch_shape, *, dtype, device):
    """eta = diag(-1, 1, 1, 1) broadcast to batch_shape + (4, 4)."""
    eta = torch.diag(torch.tensor([-1.0, 1.0, 1.0, 1.0], dtype=dtype,
                                  device=device))
    return eta.expand(tuple(batch_shape) + (4, 4))


def _l_four(l_lower, time_component):
    t = torch.full(l_lower.shape[:-1] + (1,), time_component,
                   dtype=l_lower.dtype, device=l_lower.device)
    return torch.cat([t, l_lower], dim=-1)


def gcov(x, spin, mass=1.0, flat=False):
    """Covariant CKS metric g_{munu} (geodesic_geometry.cpp:38-93)."""
    eta = minkowski(x.shape[:-1], dtype=x.dtype, device=x.device)
    if flat:
        return eta
    _, f, l_lower = ks_scalars(x, spin, mass)
    l_cov = _l_four(l_lower, 1.0)
    return eta + f[..., None, None] * l_cov[..., :, None] * l_cov[..., None, :]


def gcon(x, spin, mass=1.0, flat=False):
    """Contravariant CKS metric g^{munu} (geodesic_geometry.cpp:105-161)."""
    eta = minkowski(x.shape[:-1], dtype=x.dtype, device=x.device)
    if flat:
        return eta
    _, f, l_lower = ks_scalars(x, spin, mass)
    l_con = _l_four(l_lower, -1.0)
    return eta - f[..., None, None] * l_con[..., :, None] * l_con[..., None, :]


def ks_derivatives_c(xx, yy, z, spin, mass=1.0):
    """Kerr-Schild scalars and their spatial derivatives, per component
    (geodesic_geometry.cpp:173-276 without materializing (3, 4, 4)
    tensors).

    Returns (r, f, (l1, l2, l3), (df_dx, df_dy, df_dz), (dl1, dl2, dl3)),
    each dli a 3-tuple of d(l_i)/d(x, y, z).
    """
    a2 = spin * spin
    rr2 = xx * xx + yy * yy + z * z
    r2 = 0.5 * (rr2 - a2 + torch.hypot(rr2 - a2, 2.0 * spin * z))
    r = torch.sqrt(r2)
    f = 2.0 * mass * r2 * r / (r2 * r2 + a2 * z * z)
    denom = r2 + a2
    l1 = (r * xx + spin * yy) / denom
    l2 = (r * yy - spin * xx) / denom
    l3 = z / r

    dr_denom = 2.0 * r2 - rr2 + a2
    dr_dx = r * xx / dr_denom
    dr_dy = r * yy / dr_denom
    dr_dz = (r * z + a2 * z / r) / dr_denom
    f_denom = r * (r2 * r2 + a2 * z * z)
    poly = r2 * r2 - 3.0 * a2 * z * z
    df_dx = -poly * dr_dx / f_denom * f
    df_dy = -poly * dr_dy / f_denom * f
    df_dz = -(poly * dr_dz + 2.0 * a2 * r * z) / f_denom * f

    c1 = (xx - 2.0 * r * l1) / denom
    c2 = (yy - 2.0 * r * l2) / denom
    a_denom = (1.0 / denom) * spin
    dl1 = (c1 * dr_dx + r / denom, c1 * dr_dy + a_denom, c1 * dr_dz)
    dl2 = (c2 * dr_dx - a_denom, c2 * dr_dy + r / denom, c2 * dr_dz)
    dl3 = (-z / r2 * dr_dx, -z / r2 * dr_dy, -z / r2 * dr_dz + 1.0 / r)
    return r, f, (l1, l2, l3), (df_dx, df_dy, df_dz), (dl1, dl2, dl3)


def geodesic_rhs_c(x1, x2, x3, p0, p1, p2, p3, spin, mass=1.0, flat=False,
                   with_distance=False):
    """Geodesic right-hand side (geodesics.cpp:867-925), rank-1 form.

    Returns (dx0, dx1, dx2, dx3, dp1, dp2, dp3[, ds]); dp0 = 0.
    """
    if flat:
        zero = torch.zeros_like(p0)
        out = (-p0, p1, p2, p3, zero, zero, zero)
        if not with_distance:
            return out
        return out + (-torch.sqrt(p1 * p1 + p2 * p2 + p3 * p3),)

    r, f, (l1, l2, l3), df, (dl1, dl2, dl3) = ks_derivatives_c(
        x1, x2, x3, spin, mass)
    lp = -p0 + l1 * p1 + l2 * p2 + l3 * p3
    flp = f * lp
    k0 = -p0 + flp
    k1 = p1 - flp * l1
    k2 = p2 - flp * l2
    k3 = p3 - flp * l3
    dlp1 = dl1[0] * p1 + dl2[0] * p2 + dl3[0] * p3
    dlp2 = dl1[1] * p1 + dl2[1] * p2 + dl3[1] * p3
    dlp3 = dl1[2] * p1 + dl2[2] * p2 + dl3[2] * p3
    half_lp2 = 0.5 * lp * lp
    dp1 = df[0] * half_lp2 + flp * dlp1
    dp2 = df[1] * half_lp2 + flp * dlp2
    dp3 = df[2] * half_lp2 + flp * dlp3
    out = (k0, k1, k2, k3, dp1, dp2, dp3)
    if not with_distance:
        return out
    scale = f * k0 / (-1.0 - f)
    q1 = k1 - scale * l1
    q2 = k2 - scale * l2
    q3 = k3 - scale * l3
    lq = l1 * q1 + l2 * q2 + l3 * q3
    ds2 = q1 * q1 + q2 * q2 + q3 * q3 + f * lq * lq
    # Floor strictly above 0 (a 0-clamp has an infinite sqrt derivative)
    ds = -torch.sqrt(torch.clamp(ds2, min=1e-300))
    return out + (ds,)


def renormalize_factor_c(x1, x2, x3, p0, p1, p2, p3, spin, mass=1.0,
                         flat=False):
    """Scale s on (p_1, p_2, p_3) that makes p null at fixed p_0
    (geodesics.cpp:295-309): the stable root of a s^2 + b s + c = 0 with
      a = |p_s|^2 - f (l_s.p_s)^2,  b = 2 f (l_s.p_s) p_0,
      c = -(1 + f) p_0^2.
    """
    if flat:
        a = p1 * p1 + p2 * p2 + p3 * p3
        b = torch.zeros_like(p0)
        c = -p0 * p0
    else:
        a2s = spin * spin
        rr2 = x1 * x1 + x2 * x2 + x3 * x3
        r2 = 0.5 * (rr2 - a2s + torch.hypot(rr2 - a2s, 2.0 * spin * x3))
        r = torch.sqrt(r2)
        f = 2.0 * mass * r2 * r / (r2 * r2 + a2s * x3 * x3)
        denom = r2 + a2s
        l1 = (r * x1 + spin * x2) / denom
        l2 = (r * x2 - spin * x1) / denom
        l3 = x3 / r
        lsps = l1 * p1 + l2 * p2 + l3 * p3
        a = p1 * p1 + p2 * p2 + p3 * p3 - f * lsps * lsps
        b = 2.0 * f * lsps * p0
        c = -(1.0 + f) * p0 * p0
    d = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=1e-300))
    use_neg = b < 0.0
    denom_a = torch.where(use_neg, 2.0 * a, 1.0)
    denom_b = torch.where(use_neg, 1.0, b + d)
    return torch.where(use_neg, (d - b) / denom_a, -2.0 * c / denom_b)


def null_momentum_time_component(g_cov, p_spatial):
    """p^0 from g_{munu} p^mu p^nu = 0 given contravariant p^i, with the
    reference camera's root choice (camera.cpp:554-566).

    Args:
      g_cov: (..., 4, 4) covariant metric.
      p_spatial: (..., 3) contravariant spatial momentum.
    """
    a = g_cov[..., 0, 0]
    b = 2.0 * torch.einsum("...i,...i->...", g_cov[..., 0, 1:], p_spatial)
    c = torch.einsum("...ij,...i,...j->...", g_cov[..., 1:, 1:], p_spatial,
                     p_spatial)
    d = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    root_bneg = 2.0 * c / (d - b)
    root_else = -(b + d) / (2.0 * a)
    root = torch.where(b < 0.0, root_bneg, root_else)
    degenerate = -c / (2.0 * b)
    return torch.where(a == 0.0, degenerate, root)


def renormalize_null_momentum(g_con, p_cov):
    """Rescale the spatial covariant momentum so g^{munu} p_mu p_nu = 0,
    keeping p_0 (geodesics.cpp:295-309).

    Args:
      g_con: (..., 4, 4) contravariant metric.
      p_cov: (..., 4) covariant momentum.
    """
    p0 = p_cov[..., 0]
    ps = p_cov[..., 1:]
    a = torch.einsum("...ij,...i,...j->...", g_con[..., 1:, 1:], ps, ps)
    b = 2.0 * p0 * torch.einsum("...i,...i->...", g_con[..., 0, 1:], ps)
    c = g_con[..., 0, 0] * p0 * p0
    d = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    factor = torch.where(b < 0.0, (d - b) / (2.0 * a), -2.0 * c / (b + d))
    return torch.cat([p0[..., None], ps * factor[..., None]], dim=-1)
