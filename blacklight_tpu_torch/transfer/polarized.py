"""Polarized (full-Stokes IQUV) radiative transfer on tensors.

Port of ``blacklight_tpu/transfer/polarized.py``: the coherency-tensor
bookkeeping (``_SYM``, ``_ANT``, ``_transport_c``, ``_stokes_from_n``,
``_n_from_stokes``, :49-140), ``_kcon_scalar`` (:202), ``camera_stokes``
(:143) and ``integrate_polarized`` (:216-613) with its auxiliary image
planes (``AuxPlanes``), without stored samples (ROADMAP A.8). The
reference is polarized.cpp:51-973.

The state per ray and frequency is the Hermitian coherency tensor N^{mn},
carried as 10 real-symmetric and 6 imaginary-antisymmetric components.
Samples are taken far end first: the geodesic sweep keeps only each
window's entering state (``ops/geodesic.segment_carries``) and replays
one window at a time, so memory is O(S / W + W) in the S steps. Per
sample, ``sample_record`` forms everything that does not depend on N
(the transport matrices, the step lengths, the fluid tetrad, the
coefficients times the step) and ``apply_record`` applies it to N: the
previous sample's deferred second-half transport, the averaged
first-half transport, N -> Stokes, the matter coupling
(``polarized_coupling.couple_matter_scaled_c``) and Stokes -> N. The
CUDA route runs the two as separate kernels.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from blacklight_tpu_torch.constants import NUM_CELL_VALUES, Physics
from blacklight_tpu_torch.ops import geodesic, geometry
from blacklight_tpu_torch.ops.connection import transport_matrix_c
from blacklight_tpu_torch.ops.tetrad import tetrad_rows_c
from blacklight_tpu_torch.transfer import unpolarized as tu
from blacklight_tpu_torch.transfer.polarized_coupling import (
    couple_matter_scaled_c)

# Steps per replayed window of the plain version (JAX's XLA default).
WINDOW = 64

_SYM = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3), (2, 2),
        (2, 3), (3, 3))
_ANT = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_SYM_POS = {}
for _i, (_m, _n) in enumerate(_SYM):
    _SYM_POS[(_m, _n)] = _i
    _SYM_POS[(_n, _m)] = _i
_ANT_POS = {mn: i for i, mn in enumerate(_ANT)}


def _re_at(re, m, n):
    return re[_SYM_POS[(m, n)]]


def _im_at(im, m, n):
    """Im N^{mn} with antisymmetry folded in; None where it is 0."""
    if m == n:
        return None
    if m < n:
        return im[_ANT_POS[(m, n)]]
    return -im[_ANT_POS[(n, m)]]


def _transport_c(a_mat, re, im, base_re, base_im, dl):
    """Half-step parallel transport (polarized.cpp:174-192):
    new = base - dl (A^m_b N^{bn} + A^n_b N^{mb}) per stored component."""
    new_re = []
    for i, (m, n) in enumerate(_SYM):
        d = None
        for bb in range(4):
            t = a_mat[m][bb] * _re_at(re, bb, n) \
                + a_mat[n][bb] * _re_at(re, m, bb)
            d = t if d is None else d + t
        new_re.append(base_re[i] - dl * d)
    new_im = []
    for i, (m, n) in enumerate(_ANT):
        d = None
        for bb in range(4):
            v = _im_at(im, bb, n)
            if v is not None:
                t = a_mat[m][bb] * v
                d = t if d is None else d + t
            v = _im_at(im, m, bb)
            if v is not None:
                t = a_mat[n][bb] * v
                d = t if d is None else d + t
        new_im.append(base_im[i] - dl * d)
    return tuple(new_re), tuple(new_im)


def _stokes_from_n(e1, e2, re, im):
    """Tetrad-frame (I, Q, U, V) from the coherency components
    (polarized.cpp:264-292, I 14); e1, e2 are the covariant tetrad rows."""
    nt00 = nt11 = nt01 = None
    for m in range(4):
        t00 = e1[m] * e1[m] * _re_at(re, m, m)
        t11 = e2[m] * e2[m] * _re_at(re, m, m)
        t01 = e1[m] * e2[m] * _re_at(re, m, m)
        nt00 = t00 if nt00 is None else nt00 + t00
        nt11 = t11 if nt11 is None else nt11 + t11
        nt01 = t01 if nt01 is None else nt01 + t01
    for m, n in _ANT:
        r = re[_SYM_POS[(m, n)]]
        nt00 = nt00 + 2.0 * e1[m] * e1[n] * r
        nt11 = nt11 + 2.0 * e2[m] * e2[n] * r
        nt01 = nt01 + (e1[m] * e2[n] + e1[n] * e2[m]) * r
    s_v = None
    for i, (m, n) in enumerate(_ANT):
        t = (e2[m] * e1[n] - e2[n] * e1[m]) * im[i]
        s_v = t if s_v is None else s_v + t
    return (0.5 * (nt00 + nt11), 0.5 * (nt00 - nt11), nt01, s_v)


def _n_from_stokes(t1, t2, s_i, s_q, s_u, s_v):
    """Coherency components from tetrad-frame Stokes (I 13,
    polarized.cpp:793-813); t1, t2 are the contravariant tetrad rows."""
    ipq = s_i + s_q
    imq = s_i - s_q
    re = tuple(
        t1[m] * t1[n] * ipq + (t1[m] * t2[n] + t2[m] * t1[n]) * s_u
        + t2[m] * t2[n] * imq
        for (m, n) in _SYM)
    im = tuple(s_v * (t2[m] * t1[n] - t1[m] * t2[n]) for (m, n) in _ANT)
    return re, im


def _ks_f_l(x1, x2, x3, spin, mass):
    """(f, (l1, l2, l3)) of the Kerr-Schild metric, as geometry.ks_scalars
    forms them."""
    _, f, l_lower = geometry.ks_scalars(torch.stack([x1, x2, x3], dim=-1),
                                        spin, mass)
    return f, l_lower.unbind(-1)


def _kcon_scalar(pos, kcov, spin, mass, flat):
    """g^{mn} k_n through the rank-1 Kerr-Schild structure; pos and kcov
    are 4-tuples of components."""
    if flat:
        return (-kcov[0], kcov[1], kcov[2], kcov[3])
    f, (l1, l2, l3) = _ks_f_l(pos[1], pos[2], pos[3], spin, mass)
    lp = -kcov[0] + l1 * kcov[1] + l2 * kcov[2] + l3 * kcov[3]
    flp = f * lp
    return (-kcov[0] + flp, kcov[1] - flp * l1, kcov[2] - flp * l2,
            kcov[3] - flp * l3)


def camera_stokes(nn_re, nn_im, positions, directions, spin, mass, flat,
                  frequencies, camera_u_con, camera_u_cov, camera_vert_con_c,
                  log_j_scale):
    """Camera-frame Stokes (polarized.cpp:846-949): the camera tetrad of
    each pixel projects the final coherency components (nn_re (B, F, 10),
    nn_im (B, F, 6)), times the nu^3 invariant scale. Returns (I, Q, U,
    V), each (B, F)."""
    b = positions.shape[0]
    pos = positions.unbind(-1)
    kcov = directions.unbind(-1)
    kcon = _kcon_scalar(pos, kcov, spin, mass, flat)
    u_con, u_cov, vert = camera_u_con, camera_u_cov, camera_vert_con_c
    up_con = torch.cat([
        (u_con[0] * vert[0] - (u_cov[1] * vert[1] + u_cov[2] * vert[2]
                               + u_cov[3] * vert[3]) / u_cov[0])[None],
        vert[1:] + u_con[1:] * vert[0]]).to(positions.dtype)

    def each(v):
        return tuple(v[m].expand(b) for m in range(4))

    if flat:
        f_cam = torch.zeros_like(pos[0])
        l_cam = (f_cam, f_cam, f_cam)
    else:
        f_cam, l_cam = _ks_f_l(pos[1], pos[2], pos[3], spin, mass)
    _, _, e1, e2 = tetrad_rows_c(
        each(u_con.to(positions.dtype)), kcon, kcov, each(up_con), f_cam,
        l_cam, ucov=each(u_cov.to(positions.dtype)))
    e1 = [c[:, None] for c in e1]
    e2 = [c[:, None] for c in e2]
    s_i, s_q, s_u, s_v = _stokes_from_n(e1, e2, nn_re.unbind(-1),
                                        nn_im.unbind(-1))
    scale = torch.exp(torch.tensor(log_j_scale, dtype=positions.dtype,
                                   device=positions.device)
                      + 3.0 * torch.log(frequencies[None, :]))
    return s_i * scale, s_q * scale, s_u * scale, s_v * scale


RECORD_COEFFICIENTS = ("j_i", "j_q", "j_v", "alpha_i", "alpha_q", "alpha_v",
                       "rho_q", "rho_v")


def sample_record(pos, kcov, h, first, prev, coeff_fn, *, nus, mom, x_unit,
                  spin, mass, flat):
    """Everything of one sample of each ray that does not depend on the
    coherency tensor: the derive kernel's record
    (csrc/polarized_kernel.cuh polarized_derive_kernel).

    pos, kcov: 4-tuples of (B,) components; h the signed step (B,);
    first (B,) marks the far end of each ray, where no farther sample
    exists; prev = (pos_pv, kcon_pv, dl_pv) of the next-farther sample
    (its position 4-tuple, contravariant momentum 4-tuple and step -h);
    coeff_fn as integrate_polarized takes it; nus (1, F) and mom (B, 1)
    the frequencies and momentum factors.

    Returns a dict: "kcon" (4-tuple), "a_cur" (the sample's transport
    matrix A(x, k), 4 x 4 nested tuples), "a_half" (the averaged matrix
    of its first half), "dl_sec" and "dl_local" (the deferred and local
    half-step lengths), the tetrad rows "e1", "e2" (covariant) and "t1",
    "t2" (contravariant), "coef" (the coefficients in
    RECORD_COEFFICIENTS order times the step in cm, each (B, F)),
    "dl_cgs" (B, F), that step, and "bad" (B, F).
    """
    pos_pv, kcon_prev, dl_pv = prev
    dl_cur = -h
    dl_cgs = dl_cur[:, None] * x_unit / (nus * mom)

    # transport matrices; the averaged first-half matrix expands by
    # bilinearity: 0.5 A(prev, k_old) + 0.25 A(cur, k_prev)
    # + 0.25 A(cur, k)
    kcon = _kcon_scalar(pos, kcov, spin, mass, flat)
    kcon_old = tuple(torch.where(first, kcon[m],
                                 0.5 * (kcon_prev[m] + kcon[m]))
                     for m in range(4))
    derivs = None if flat else geometry.ks_derivatives_c(
        pos[1], pos[2], pos[3], spin, mass)
    a_cur = transport_matrix_c(pos[1], pos[2], pos[3], *kcon, spin, mass,
                               flat=flat, derivs=derivs)
    a_cur_kprev = transport_matrix_c(pos[1], pos[2], pos[3], *kcon_prev,
                                     spin, mass, flat=flat, derivs=derivs)
    a_prev_kold = transport_matrix_c(pos_pv[1], pos_pv[2], pos_pv[3],
                                     *kcon_old, spin, mass, flat=flat)
    a_half = tuple(tuple(torch.where(first, a_cur[m][n],
                                     0.5 * a_prev_kold[m][n]
                                     + 0.25 * a_cur_kprev[m][n]
                                     + 0.25 * a_cur[m][n])
                         for n in range(4)) for m in range(4))

    coeffs = coeff_fn(pos, kcov)
    if flat:
        f_ks = torch.zeros_like(pos[0])
        l_ks = (f_ks, f_ks, f_ks)
    else:
        _, f_ks, l_ks, _, _ = derivs
    upcon = tuple(torch.where(coeffs["b_zero"], 1.0 if m == 3 else 0.0,
                              coeffs["bcon"][m]) for m in range(4))
    t1, t2, e1, e2 = tetrad_rows_c(coeffs["ucon"], kcon, kcov, upcon, f_ks,
                                   l_ks)
    return {"kcon": kcon, "a_cur": a_cur, "a_half": a_half,
            "dl_sec": 0.25 * (dl_pv + dl_cur),
            "dl_local": 0.5 * (torch.where(first, 0.0, dl_pv) + dl_cur),
            "e1": e1, "e2": e2, "t1": t1, "t2": t2,
            "coef": tuple(coeffs[k] * dl_cgs for k in RECORD_COEFFICIENTS),
            "dl_cgs": dl_cgs, "bad": coeffs["bad"]}


def apply_record(re, im, a_prev, record, rotation_split: bool):
    """One sample's step of the transfer on the coherency components
    (re, im: 10- and 6-tuples of (B, F)): the next-farther sample's
    deferred second half with its matrix ``a_prev`` (4 x 4 nested tuples
    of (B,)), this sample's first half, N -> Stokes, the matter coupling
    and Stokes -> N, from ``record`` (sample_record's). The chain kernel's
    step (csrc/polarized_kernel.cuh polarized_chain_kernel). Returns the
    new (re, im)."""
    def col(v):
        return v[:, None]

    a_prev = [[col(v) for v in row] for row in a_prev]
    a_half = [[col(v) for v in row] for row in record["a_half"]]
    # the previous sample's deferred second half (its step is this
    # sample's), then this sample's first half
    nn_sec = _transport_c(a_prev, re, im, re, im, col(record["dl_sec"]))
    nn_re, nn_im = _transport_c(a_half, *nn_sec, re, im,
                                col(record["dl_local"]))
    stokes = _stokes_from_n([col(c) for c in record["e1"]],
                            [col(c) for c in record["e2"]], nn_re, nn_im)
    stokes = couple_matter_scaled_c(*stokes, *record["coef"], rotation_split)
    return _n_from_stokes([col(c) for c in record["t1"]],
                          [col(c) for c in record["t2"]], *stokes)


def finish_transport(re, im, a_prev, dl_pv):
    """The camera end: the nearest sample's second half, with its own
    step dl_pv (B,). Returns (nn_re (B, F, 10), nn_im (B, F, 6))."""
    a_prev = [[v[:, None] for v in row] for row in a_prev]
    nn_re, nn_im = _transport_c(a_prev, re, im, re, im,
                                (0.5 * dl_pv)[:, None])
    return torch.stack(nn_re, dim=-1), torch.stack(nn_im, dim=-1)


def integrate_polarized(positions, directions, momentum_factors, frequencies,
                        *, params: geodesic.GeodesicParams, integrator: str,
                        coeff_fn: Callable, mass_msun: float,
                        rotation_split: bool, window: int = WINDOW,
                        opts: Optional[tu.ImageOptions] = None,
                        cell_fn: Optional[Callable] = None, camera_x=None,
                        log_j_scale: float = 0.0):
    """Full-Stokes transfer over a ray bundle, with the auxiliary image
    planes that ``opts`` asks for.

    coeff_fn(pos, kcov) takes 4-tuples of (B,) components and returns a
    dict with (B, F) j_i/j_q/j_v (scaled as models/synchrotron does),
    alpha_i/alpha_q/alpha_v, rho_q/rho_v and "bad" (samples the reference
    would NaN, coefficients zeroed there), the 4-tuples "ucon" and "bcon"
    and the (B,) "b_zero". cell_fn(pos, kcov) -> (B, NUM_CELL_VALUES),
    NaN where invalid, for the lambda_ave, emission_ave and tau_int
    planes; camera_x (four Python floats) for crossings; log_j_scale the
    unit of the scaled j, for emission.

    Returns (nn_re (B, F, 10), nn_im (B, F, 6), flags (B,) bool,
    n_samples (B,) int32, bad (B, F) bool, planes): the coherency
    components at the camera end, before ``camera_stokes``, and the dict
    of the finished auxiliary planes (``AuxPlanes``; empty without
    opts).
    """
    b, nf = positions.shape[0], frequencies.shape[0]
    dtype, device = positions.dtype, positions.device
    spin, mass, flat = params.bh_a, params.bh_m, params.ray_flat
    x_unit = tu.x_unit(mass_msun)
    starts, flags, n_samples = geodesic.segment_carries(
        positions, directions, params, integrator, window)
    p0 = directions[:, 0]
    mom = momentum_factors[:, None]
    nus = frequencies[None, :]

    zero_bf = torch.zeros((b, nf), dtype=dtype, device=device)
    zero_b = torch.zeros(b, dtype=dtype, device=device)
    st = {"re": (zero_bf,) * 10, "im": (zero_bf,) * 6,
          "bad": torch.zeros((b, nf), dtype=torch.bool, device=device),
          "started": torch.zeros(b, dtype=torch.bool, device=device),
          "pos_pv": tuple(positions.unbind(-1)), "dl_pv": zero_b,
          "kcon_pv": (zero_b,) * 4,
          "a_prev": tuple((zero_b,) * 4 for _ in range(4))}
    planes = None if opts is None else AuxPlanes(
        opts, b, nf, dtype, device, x_unit=x_unit, spin=spin, mass=mass,
        flat=flat, cell_fn=cell_fn, camera_x=camera_x)

    def update(sample):
        active, pos, kcov, h = sample
        first = active & ~st["started"]
        rec = sample_record(pos, kcov, h, first,
                            (st["pos_pv"], st["kcon_pv"], st["dl_pv"]),
                            coeff_fn, nus=nus, mom=mom, x_unit=x_unit,
                            spin=spin, mass=mass, flat=flat)
        if planes is not None:
            planes.update(active, pos, kcov, h, st["started"], rec["coef"],
                          rec["dl_cgs"])
        post_re, post_im = apply_record(st["re"], st["im"], st["a_prev"],
                                        rec, rotation_split)
        act = active[:, None]
        st["bad"] = st["bad"] | (act & rec["bad"])
        st["re"] = tuple(torch.where(act, n, o)
                         for n, o in zip(post_re, st["re"]))
        st["im"] = tuple(torch.where(act, n, o)
                         for n, o in zip(post_im, st["im"]))
        st["a_prev"] = tuple(tuple(torch.where(active, rec["a_cur"][m][n],
                                               st["a_prev"][m][n])
                                   for n in range(4)) for m in range(4))
        st["kcon_pv"] = tuple(torch.where(active, rec["kcon"][m],
                                          st["kcon_pv"][m])
                              for m in range(4))
        st["pos_pv"] = tuple(torch.where(active, pos[m], st["pos_pv"][m])
                             for m in range(4))
        st["dl_pv"] = torch.where(active, -h, st["dl_pv"])
        st["started"] = st["started"] | active

    for k in reversed(range(len(starts))):
        for sample in reversed(geodesic.replay_window(
                starts[k], p0, params, integrator, k, window)):
            # a step with no valid sample leaves every accumulator as it is
            if bool(sample.valid.any()):
                update(sample)

    nn_re, nn_im = finish_transport(st["re"], st["im"], st["a_prev"],
                                    st["dl_pv"])
    finished = {} if planes is None else planes.finish(
        (flags & opts.fallback_nan)[:, None] | st["bad"], log_j_scale)
    return nn_re, nn_im, flags, n_samples, st["bad"], finished


class AuxPlanes:
    """The auxiliary image planes of the polarized transfer
    (polarized.py:298-320, :427-500, :589-612). Samples come far end
    first, so these forms differ from integrate_unpolarized's: the
    length's square root through a double where, lambda_tot and
    emission_tot as the averages' denominators, the far-to-camera tau_int
    recurrence, crossings counted from a ray's second sample on
    (``started``)."""

    def __init__(self, opts: tu.ImageOptions, b: int, nf: int, dtype, device,
                 *, x_unit: float, spin: float, mass: float, flat: bool,
                 cell_fn, camera_x):
        if opts.cells and cell_fn is None:
            raise ValueError(
                "cell_fn required for lambda_ave/emission_ave/tau_int")
        self.opts, self.cell_fn, self.dtype = opts, cell_fn, dtype
        self.x_unit, self.t_unit = x_unit, x_unit / Physics.c
        self.metric = (spin, mass, flat)
        self.cam = None if camera_x is None else [float(v) for v in camera_x]

        def zeros(*shape, kind=dtype):
            return torch.zeros(shape, dtype=kind, device=device)

        st = {}
        if opts.time:
            st["time"] = zeros(b)
        if opts.length:
            st["length"] = zeros(b)
        if opts.lam:
            st["lambda"] = zeros(b, nf)
        if opts.emission:
            st["emission"] = zeros(b, nf)
        if opts.tau:
            st["tau"] = zeros(b, nf)
        if opts.crossings:
            st["crossings"] = zeros(b, kind=torch.int32)
            st["plane_sign"] = zeros(b, kind=torch.bool)
        if opts.lambda_ave:
            st["lambda_ave"] = zeros(b, nf, NUM_CELL_VALUES)
            st["lambda_tot"] = zeros(b, nf)
        if opts.emission_ave:
            st["emission_ave"] = zeros(b, nf, NUM_CELL_VALUES)
            st["emission_tot"] = zeros(b, nf)
        if opts.tau_int:
            st["tau_int"] = zeros(b, nf, NUM_CELL_VALUES)
        self.st = st

    def update(self, active, pos, kcov, h, started, coef, dl_cgs):
        """One sample of each ray: ``active`` (B,) marks the rays whose
        sample counts, ``pos``/``kcov`` 4-tuples, ``h`` the signed step,
        ``started`` the rays with a farther sample, ``coef`` the record's
        coefficients times dl_cgs (RECORD_COEFFICIENTS order)."""
        opts, st = self.opts, self.st
        acol = active[:, None]
        dl_cur = -h
        j_dl, alpha_dl = coef[0], coef[3]
        if opts.time:
            st["time"] = torch.where(
                active, torch.minimum(st["time"], pos[0] * self.t_unit),
                st["time"])
        if opts.length:
            dl2 = tu.proper_length(torch.stack(pos, dim=-1),
                                   torch.stack(kcov, dim=-1), *self.metric)
            # the square root through a double where: parked rays reach
            # dl2 == 0 exactly
            dl2_pos = dl2 > 0.0
            root = torch.where(
                dl2_pos, torch.sqrt(torch.where(dl2_pos, dl2, 1.0)), 0.0)
            st["length"] = st["length"] + torch.where(
                active, root * dl_cur * self.x_unit, 0.0)
        if opts.lam:
            st["lambda"] = st["lambda"] + torch.where(acol, dl_cgs, 0.0)
        if opts.emission:
            st["emission"] = st["emission"] + torch.where(acol, j_dl, 0.0)
        if opts.tau:
            st["tau"] = st["tau"] + torch.where(acol, alpha_dl, 0.0)
        if opts.crossings:
            sign_new = tu.plane_sign(self.cam, *pos[1:])
            flipped = active & started & (sign_new != st["plane_sign"])
            st["crossings"] = st["crossings"] + flipped.to(torch.int32)
            st["plane_sign"] = torch.where(active, sign_new,
                                           st["plane_sign"])
        if not opts.cells:
            return
        cells = self.cell_fn(pos, kcov)
        cells_ok = (acol & ~torch.isnan(cells[:, 0:1]))[:, :, None]
        cells = torch.where(torch.isnan(cells), 0.0, cells)[:, None, :]
        if opts.lambda_ave:
            st["lambda_tot"] = st["lambda_tot"] + torch.where(acol, dl_cgs,
                                                              0.0)
            st["lambda_ave"] = st["lambda_ave"] + torch.where(
                cells_ok, cells * dl_cgs[..., None], 0.0)
        if opts.emission_ave:
            st["emission_tot"] = st["emission_tot"] + torch.where(
                acol, j_dl, 0.0)
            st["emission_ave"] = st["emission_ave"] + torch.where(
                cells_ok, cells * j_dl[..., None], 0.0)
        if opts.tau_int:
            thin = alpha_dl <= tu.DELTA_TAU_MAX
            # exp(-dt) old + cells (1 - exp(-dt)), overflow-free
            exp_neg = torch.exp(-alpha_dl)
            new = torch.where(thin[..., None],
                              exp_neg[..., None] * st["tau_int"]
                              + cells * (1.0 - exp_neg)[..., None],
                              cells.expand(st["tau_int"].shape))
            st["tau_int"] = torch.where(cells_ok, new, st["tau_int"])

    def finish(self, poison, log_j_scale: float) -> dict:
        """The planes, NaN (zero for lambda_ave) where ``poison`` (B, F):
        the flagged rays under fallback_nan and those that met a sample
        the reference would NaN."""
        opts, st = self.opts, self.st
        out = {}
        if opts.time:
            out["time"] = st["time"]
        if opts.length:
            out["length"] = st["length"]
        if opts.lam:
            out["lambda"] = st["lambda"]
        if opts.emission:
            out["emission"] = torch.where(
                poison, math.nan, st["emission"] * tu.emission_scale(
                    log_j_scale, self.dtype, poison.device))
        if opts.tau:
            out["tau"] = torch.where(poison, math.nan, st["tau"])
        if opts.lambda_ave:
            ave = st["lambda_ave"] / st["lambda_tot"][..., None]
            out["lambda_ave"] = torch.where(poison[..., None], 0.0, ave)
        if opts.emission_ave:
            ave = st["emission_ave"] / st["emission_tot"][..., None]
            out["emission_ave"] = torch.where(poison[..., None], math.nan,
                                              ave)
        if opts.tau_int:
            out["tau_int"] = torch.where(poison[..., None], math.nan,
                                         st["tau_int"])
        if opts.crossings:
            out["crossings"] = st["crossings"].to(self.dtype)
        return out
