"""Rows 1 and 2 of the orthonormal fluid tetrad, per component.

Port of ``blacklight_tpu/ops/tetrad.py`` ``tetrad_rows_c`` (:43), the
construction of reference radiation_geometry.cpp:597-658 with the metric
applied through its rank-1 Kerr-Schild structure: e_0 = u, e_3 along the
projection of k orthogonal to u, e_2 along the projection of ``up``
(usually b) orthogonal to both, e_1 completing a right-handed frame
through the Levi-Civita contraction (|det g| = 1 in CKS).
"""

from __future__ import annotations

import torch


def tetrad_rows_c(ucon, kcon, kcov, up_con, f, l_cov, ucov=None):
    """Tetrad rows e_1 and e_2, contravariant and covariant.

    Args:
      ucon, kcon, up_con: 4-tuples of contravariant components.
      kcov: 4-tuple of covariant components.
      f: the Kerr-Schild scalar (zeros for flat spacetime).
      l_cov: (l1, l2, l3), the spatial covariant null vector (l_0 = 1).
      ucov: the covariant u to use in place of lowering ucon (the camera
        frame passes the camera's own).

    Returns (t1, t2, e1_cov, e2_cov), each a 4-tuple of tensors.
    """
    l1, l2, l3 = l_cov

    def ldot(v):
        return v[0] + l1 * v[1] + l2 * v[2] + l3 * v[3]

    def cov(v):
        lv = f * ldot(v)
        return (-v[0] + lv, v[1] + l1 * lv, v[2] + l2 * lv, v[3] + l3 * lv)

    def con(w):
        lw = f * (-w[0] + l1 * w[1] + l2 * w[2] + l3 * w[3])
        return (-w[0] + lw, w[1] - l1 * lw, w[2] - l2 * lw, w[3] - l3 * lw)

    def dot4(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]

    def inner(a, b):
        return (-a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]
                + f * ldot(a) * ldot(b))

    omega = -dot4(kcov, ucon)
    k_up = dot4(kcov, up_con) / omega
    if ucov is None:
        ucov = cov(ucon)
    u_up = dot4(ucov, up_con) / omega

    e0 = ucon
    e3 = tuple(kcon[m] / omega - ucon[m] for m in range(4))
    e2 = tuple(up_con[m] - k_up * e3[m] + u_up * kcon[m] for m in range(4))
    norm = torch.sqrt(inner(e2, e2))
    e2 = tuple(c / norm for c in e2)

    def lc_term(a, b, c):
        return e0[a] * (e2[b] * e3[c] - e2[c] * e3[b])

    e1_cov = (
        lc_term(1, 3, 2) + lc_term(2, 1, 3) + lc_term(3, 2, 1),
        lc_term(0, 2, 3) + lc_term(2, 3, 0) + lc_term(3, 0, 2),
        lc_term(0, 3, 1) + lc_term(1, 0, 3) + lc_term(3, 1, 0),
        lc_term(0, 1, 2) + lc_term(1, 2, 0) + lc_term(2, 0, 1),
    )
    return con(e1_cov), e2, e1_cov, cov(e2)
