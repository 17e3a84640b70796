"""The parallel-transport matrix of the polarized transfer, per component.

Port of ``blacklight_tpu/ops/connection.py`` ``transport_matrix_c`` (:50):
A^m_b = k^a Gamma^m_{ab} in Cartesian Kerr-Schild coordinates from the
rank-1 structure g_{mn} = eta_{mn} + f l_m l_n, without forming the
(..., 4, 4, 4) Christoffel tensor (reference radiation_geometry.cpp:
274-410).
"""

from __future__ import annotations

import torch

from blacklight_tpu_torch.ops.geometry import ks_derivatives_c


def transport_matrix_c(x1, x2, x3, k0, k1, k2, k3, spin, mass=1.0,
                       flat=False, derivs=None):
    """A^m_b = k^a Gamma^m_{ab} at CKS positions (x1, x2, x3) for the
    contravariant vector k^a.

    With D_db = k^a d_a g_db, C_db = k^a d_b g_da, E_db = k^a d_d g_ab and
    T = D + C - E, A^m_b = 1/2 (eta^{mm} T_mb - f l^m U_b) where
    U_b = -T_0b + l_i T_ib.

    derivs: ``geometry.ks_derivatives_c`` at the same position, to share
    between calls. Returns a 4x4 nested list of tensors A[m][b].
    """
    if flat:
        zero = torch.zeros_like(k0)
        return [[zero] * 4 for _ in range(4)]
    if derivs is None:
        derivs = ks_derivatives_c(x1, x2, x3, spin, mass)
    _, f, (l1, l2, l3), (df1, df2, df3), (dl1, dl2, dl3) = derivs

    zero = torch.zeros_like(k0)
    one = torch.ones_like(k0)
    l_cov = (one, l1, l2, l3)
    lk = k0 + l1 * k1 + l2 * k2 + l3 * k3
    kdf = k1 * df1 + k2 * df2 + k3 * df3
    # kdl_d = k^a d_a l_d; s_b = k^a d_b l_a; both zero in the t slot
    kdl = (zero,
           k1 * dl1[0] + k2 * dl1[1] + k3 * dl1[2],
           k1 * dl2[0] + k2 * dl2[1] + k3 * dl2[2],
           k1 * dl3[0] + k2 * dl3[1] + k3 * dl3[2])
    s = (zero,
         dl1[0] * k1 + dl2[0] * k2 + dl3[0] * k3,
         dl1[1] * k1 + dl2[1] * k2 + dl3[1] * k3,
         dl1[2] * k1 + dl2[2] * k2 + dl3[2] * k3)
    df = (zero, df1, df2, df3)
    # p[b][d] = d_b l_d (b the direction, d the component)
    p = ((zero, zero, zero, zero),
         (zero, dl1[0], dl2[0], dl3[0]),
         (zero, dl1[1], dl2[1], dl3[1]),
         (zero, dl1[2], dl2[2], dl3[2]))

    t = [[kdf * l_cov[d] * l_cov[b]
          + f * (kdl[d] * l_cov[b] + l_cov[d] * kdl[b])
          + df[b] * l_cov[d] * lk + f * lk * p[b][d] + f * l_cov[d] * s[b]
          - df[d] * lk * l_cov[b] - f * s[d] * l_cov[b] - f * lk * p[d][b]
          for b in range(4)] for d in range(4)]
    u = [-t[0][b] + l1 * t[1][b] + l2 * t[2][b] + l3 * t[3][b]
         for b in range(4)]
    a = [[0.5 * (-t[0][b] + f * u[b]) for b in range(4)]]
    for i, li in ((1, l1), (2, l2), (3, l3)):
        a.append([0.5 * (t[i][b] - f * li * u[b]) for b in range(4)])
    return a
