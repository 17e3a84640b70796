"""Camera model: image frequencies, camera tetrad, per-pixel rays.

Port of ``blacklight_tpu/camera.py`` (reference camera.cpp:27-671). The
camera frame is host scalar algebra in float64 (math and numpy), done
once; the per-pixel rays are one batched tensor computation on
``device`` in ``dtype``. In float32 the JAX package evaluates the camera
metric in float32 while this port keeps the whole frame in float64 and
rounds once, so float32 rays may differ from the JAX package's in the
last bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from blacklight_tpu_torch.constants import (
    CameraType,
    FrequencyNormalization,
    FrequencySpacing,
)
from blacklight_tpu_torch.ops import geometry


@dataclasses.dataclass(frozen=True)
class CameraGeometry:
    """Camera frame quantities (reference camera.cpp:52-380), each a (4,)
    tensor."""

    cam_x: torch.Tensor        # camera position in CKS
    u_con: torch.Tensor        # camera 4-velocity (contravariant)
    u_cov: torch.Tensor        # camera 4-velocity (covariant)
    norm_con: torch.Tensor     # normal direction, coordinate frame
    norm_con_c: torch.Tensor   # normal direction, camera frame
    hor_con_c: torch.Tensor    # horizontal direction, camera frame
    vert_con_c: torch.Tensor   # vertical direction, camera frame


@dataclasses.dataclass(frozen=True)
class CameraRays:
    """Per-pixel ray bundle: pixel events, covariant photon momenta p_mu
    and momentum factors (camera.cpp:528-585, 608-671)."""

    positions: torch.Tensor          # (N, 4)
    directions: torch.Tensor         # (N, 4) covariant
    momentum_factors: torch.Tensor   # (N,)


def image_frequency_table(num_frequencies: int, frequency: float,
                          frequency_start: float = 0.0,
                          frequency_end: float = 0.0,
                          spacing: FrequencySpacing = FrequencySpacing.lin_freq,
                          *, device, dtype) -> torch.Tensor:
    """Ideal image frequencies (reference camera.cpp:30-50)."""
    if num_frequencies == 1:
        return torch.tensor([frequency], dtype=dtype, device=device)
    frac = np.arange(num_frequencies, dtype=np.float64) / (num_frequencies - 1)
    if spacing == FrequencySpacing.lin_freq:
        freqs = frequency_start + frac * (frequency_end - frequency_start)
    elif spacing == FrequencySpacing.lin_wave:
        freqs = 1.0 / (1.0 / frequency_start
                       + frac * (1.0 / frequency_end - 1.0 / frequency_start))
    else:  # log
        freqs = np.exp(np.log(frequency_start)
                       + frac * np.log(frequency_end / frequency_start))
    freqs[0] = frequency_start
    freqs[-1] = frequency_end
    return torch.tensor(freqs, dtype=dtype, device=device)


def _gcov_np(x, bh_a, bh_m, flat):
    """Covariant CKS metric at one point, float64 numpy (4, 4)."""
    return geometry.gcov(torch.tensor(x, dtype=torch.float64), bh_a, bh_m,
                         flat=flat).numpy()


def _gcon_np(x, bh_a, bh_m, flat):
    return geometry.gcon(torch.tensor(x, dtype=torch.float64), bh_a, bh_m,
                         flat=flat).numpy()


def camera_geometry(*, bh_m: float, bh_a: float, camera_r: float,
                    camera_th: float, camera_ph: float, camera_urn: float,
                    camera_uthn: float, camera_uphn: float,
                    camera_k_r: float, camera_k_th: float,
                    camera_k_ph: float, camera_rotation: float,
                    camera_pole: bool, ray_flat: bool,
                    device, dtype) -> CameraGeometry:
    """Camera position, velocity and orthonormal screen basis
    (reference camera.cpp:52-380), with the same special cases: the
    spherical-KS metric at the camera, the flat-space branch (ray_flat)
    and the pole-on branch (theta in {0, pi})."""
    sth, cth = math.sin(camera_th), math.cos(camera_th)
    sph, cph = math.sin(camera_ph), math.cos(camera_ph)
    srot, crot = math.sin(camera_rotation), math.cos(camera_rotation)

    # Camera position (camera.cpp:60-70)
    cam_t = 0.0
    cam_x1 = sth * (camera_r * cph - bh_a * sph)
    cam_x2 = sth * (camera_r * sph + bh_a * cph)
    cam_x3 = camera_r * cth
    if ray_flat:
        cam_x1 = camera_r * sth * cph
        cam_x2 = camera_r * sth * sph
    z_sign = 1.0 if cam_x3 >= 0.0 else -1.0

    # Metric in spherical coordinates at the camera (camera.cpp:72-150)
    a2 = bh_a * bh_a
    r2 = camera_r * camera_r
    delta = r2 - 2.0 * bh_m * camera_r + a2
    sigma = r2 + a2 * cth * cth
    if not ray_flat and not camera_pole:
        g_cov_r_r = 1.0 + 2.0 * bh_m * camera_r / sigma
        g_cov_r_th = 0.0
        g_cov_r_ph = -(1.0 + 2.0 * bh_m * camera_r / sigma) * bh_a * sth * sth
        g_cov_th_th = sigma
        g_cov_th_ph = 0.0
        g_cov_ph_ph = (r2 + a2 + 2.0 * bh_m * a2 * camera_r / sigma
                       * sth * sth) * sth * sth
        g_con_t_t = -(1.0 + 2.0 * bh_m * camera_r / sigma)
        g_con_t_r = 2.0 * bh_m * camera_r / sigma
        g_con_t_th = 0.0
        g_con_t_ph = 0.0
        g_con_r_r = delta / sigma
        g_con_r_th = 0.0
        g_con_r_ph = bh_a / sigma
        g_con_th_th = 1.0 / sigma
        g_con_th_ph = 0.0
        g_con_ph_ph = 1.0 / (sigma * sth * sth)
    elif ray_flat and not camera_pole:
        g_cov_r_r, g_cov_r_th, g_cov_r_ph = 1.0, 0.0, 0.0
        g_cov_th_th, g_cov_th_ph = r2, 0.0
        g_cov_ph_ph = r2 * sth * sth
        g_con_t_t, g_con_t_r, g_con_t_th, g_con_t_ph = -1.0, 0.0, 0.0, 0.0
        g_con_r_r, g_con_r_th, g_con_r_ph = 1.0, 0.0, 0.0
        g_con_th_th, g_con_th_ph = 1.0 / r2, 0.0
        g_con_ph_ph = 1.0 / (r2 * sth * sth)
    elif camera_pole and not ray_flat:
        f = 2.0 * bh_m * camera_r / (r2 + a2)
        g_cov_r_r, g_cov_r_th, g_cov_r_ph = 1.0 + f, 0.0, 0.0
        g_cov_th_th, g_cov_th_ph, g_cov_ph_ph = 1.0, 0.0, 1.0
        g_con_t_t = -1.0 - f
        g_con_t_r = z_sign * f
        g_con_t_th, g_con_t_ph = 0.0, 0.0
        g_con_r_r, g_con_r_th, g_con_r_ph = 1.0 - f, 0.0, 0.0
        g_con_th_th, g_con_th_ph, g_con_ph_ph = 1.0, 0.0, 1.0
    else:  # ray_flat and camera_pole
        g_cov_r_r, g_cov_r_th, g_cov_r_ph = 1.0, 0.0, 0.0
        g_cov_th_th, g_cov_th_ph, g_cov_ph_ph = 1.0, 0.0, 1.0
        g_con_t_t, g_con_t_r, g_con_t_th, g_con_t_ph = -1.0, 0.0, 0.0, 0.0
        g_con_r_r, g_con_r_th, g_con_r_ph = 1.0, 0.0, 0.0
        g_con_th_th, g_con_th_ph, g_con_ph_ph = 1.0, 0.0, 1.0

    # Camera velocity in spherical coordinates (camera.cpp:152-164)
    alpha = 1.0 / math.sqrt(-g_con_t_t)
    beta_con_r = -g_con_t_r / g_con_t_t
    beta_con_th = -g_con_t_th / g_con_t_t
    beta_con_ph = -g_con_t_ph / g_con_t_t
    utn = math.sqrt(1.0 + g_cov_r_r * camera_urn**2
                    + 2.0 * g_cov_r_th * camera_urn * camera_uthn
                    + 2.0 * g_cov_r_ph * camera_urn * camera_uphn
                    + g_cov_th_th * camera_uthn**2
                    + 2.0 * g_cov_th_ph * camera_uthn * camera_uphn
                    + g_cov_ph_ph * camera_uphn**2)
    u_con_0 = utn / alpha
    ur = camera_urn - beta_con_r / alpha * utn
    uth = camera_uthn - beta_con_th / alpha * utn
    uph = camera_uphn - beta_con_ph / alpha * utn

    # Jacobian d(x,y,z)/d(r,th,ph) (camera.cpp:166-199)
    if camera_pole:
        dx_dr, dy_dr, dz_dr = 0.0, 0.0, z_sign
        dx_dth, dy_dth, dz_dth = 1.0, 0.0, 0.0
        dx_dph, dy_dph, dz_dph = 0.0, 1.0, 0.0
    elif ray_flat:
        dx_dr, dy_dr, dz_dr = sth * cph, sth * sph, cth
        dx_dth = camera_r * cth * cph
        dy_dth = camera_r * cth * sph
        dz_dth = -camera_r * sth
        dx_dph, dy_dph, dz_dph = -camera_r * sth * sph, camera_r * sth * cph, 0.0
    else:
        dx_dr, dy_dr, dz_dr = sth * cph, sth * sph, cth
        dx_dth = cth * (camera_r * cph - bh_a * sph)
        dy_dth = cth * (camera_r * sph + bh_a * cph)
        dz_dth = -camera_r * sth
        dx_dph = sth * (-camera_r * sph - bh_a * cph)
        dy_dph = sth * (camera_r * cph - bh_a * sph)
        dz_dph = 0.0

    # Camera velocity in CKS (camera.cpp:201-212)
    u_con = np.array([
        u_con_0,
        dx_dr * ur + dx_dth * uth + dx_dph * uph,
        dy_dr * ur + dy_dth * uth + dy_dph * uph,
        dz_dr * ur + dz_dth * uth + dz_dph * uph,
    ])
    cam_x = np.array([cam_t, cam_x1, cam_x2, cam_x3])
    g_cov = _gcov_np(cam_x[1:], bh_a, bh_m, ray_flat)
    u_cov = g_cov @ u_con

    # Photon momentum in spherical coordinates (camera.cpp:214-227)
    g_con_rn_rn = (g_con_t_t * g_con_r_r - g_con_t_r * g_con_t_r) / g_con_t_t
    g_con_rn_thn = (g_con_t_t * g_con_r_th - g_con_t_r * g_con_t_th) / g_con_t_t
    g_con_rn_phn = (g_con_t_t * g_con_r_ph - g_con_t_r * g_con_t_ph) / g_con_t_t
    g_con_thn_thn = (g_con_t_t * g_con_th_th
                     - g_con_t_th * g_con_t_th) / g_con_t_t
    g_con_thn_phn = (g_con_t_t * g_con_th_ph
                     - g_con_t_th * g_con_t_ph) / g_con_t_t
    g_con_phn_phn = (g_con_t_t * g_con_ph_ph
                     - g_con_t_ph * g_con_t_ph) / g_con_t_t
    k_rn, k_thn, k_phn = camera_k_r, camera_k_th, camera_k_ph
    k_tn = -math.sqrt(g_con_rn_rn * k_rn**2 + 2.0 * g_con_rn_thn * k_rn * k_thn
                      + 2.0 * g_con_rn_phn * k_rn * k_phn
                      + g_con_thn_thn * k_thn**2
                      + 2.0 * g_con_thn_phn * k_thn * k_phn
                      + g_con_phn_phn * k_phn**2)
    k_t = alpha * k_tn + (beta_con_r * k_rn + beta_con_th * k_thn
                          + beta_con_ph * k_phn)

    # Jacobian d(r,th,ph)/d(x,y,z) at the camera (camera.cpp:229-264)
    if camera_pole:
        dr_dx, dr_dy, dr_dz = 0.0, 0.0, z_sign
        dth_dx, dth_dy, dth_dz = 1.0, 0.0, 0.0
        dph_dx, dph_dy, dph_dz = 0.0, 1.0, 0.0
    elif ray_flat:
        dr_dx = cam_x1 / camera_r
        dr_dy = cam_x2 / camera_r
        dr_dz = cam_x3 / camera_r
        dth_dx = cth * cph / camera_r
        dth_dy = cth * sph / camera_r
        dth_dz = -sth / camera_r
        dph_dx = -sph / (camera_r * sth)
        dph_dy = cph / (camera_r * sth)
        dph_dz = 0.0
    else:
        rr2 = cam_x1**2 + cam_x2**2 + cam_x3**2
        dr_dx = camera_r * cam_x1 / (2.0 * r2 - rr2 + a2)
        dr_dy = camera_r * cam_x2 / (2.0 * r2 - rr2 + a2)
        dr_dz = (camera_r * cam_x3 + a2 * cam_x3 / camera_r) / (2.0 * r2 - rr2 + a2)
        dth_dx = cam_x3 * dr_dx / (r2 * sth)
        dth_dy = cam_x3 * dr_dy / (r2 * sth)
        dth_dz = (cam_x3 * dr_dz - camera_r) / (r2 * sth)
        dph_dx = -cam_x2 / (cam_x1**2 + cam_x2**2) + bh_a / (r2 + a2) * dr_dx
        dph_dy = cam_x1 / (cam_x1**2 + cam_x2**2) + bh_a / (r2 + a2) * dr_dy
        dph_dz = bh_a / (r2 + a2) * dr_dz

    # Photon momentum in CKS (camera.cpp:266-270)
    k_x = dr_dx * camera_k_r + dth_dx * camera_k_th + dph_dx * camera_k_ph
    k_y = dr_dy * camera_k_r + dth_dy * camera_k_th + dph_dy * camera_k_ph
    k_z = dr_dz * camera_k_r + dth_dz * camera_k_th + dph_dz * camera_k_ph
    k_tc = float(u_con[0]) * k_t + float(u_con[1]) * k_x \
        + float(u_con[2]) * k_y + float(u_con[3]) * k_z

    # Contravariant metric in camera frame (camera.cpp:272-280)
    g_con4 = _gcon_np(cam_x[1:], bh_a, bh_m, ray_flat)
    g_con_c = g_con4[1:, 1:] + np.outer(u_con[1:], u_con[1:])

    # Camera normal direction in camera frame (camera.cpp:282-303)
    norm_cov_c = np.array([
        k_x - u_cov[1] / u_cov[0] * k_t,
        k_y - u_cov[2] / u_cov[0] * k_t,
        k_z - u_cov[3] / u_cov[0] * k_t,
    ])
    norm_con_c_spatial = g_con_c @ norm_cov_c
    norm_con_c0 = -k_tc
    norm_norm = math.sqrt(float(norm_cov_c @ norm_con_c_spatial))
    norm_cov_c = norm_cov_c / norm_norm
    norm_con_c = np.concatenate([[norm_con_c0 / norm_norm],
                                 norm_con_c_spatial / norm_norm])
    norm_con = np.empty(4)
    norm_con[0] = u_con[0] * norm_con_c[0] \
        - (u_cov[1] * norm_con_c[1] + u_cov[2] * norm_con_c[2]
           + u_cov[3] * norm_con_c[3]) / u_cov[0]
    norm_con[1:] = norm_con_c[1:] + u_con[1:] * norm_con_c[0]

    # Unprojected vertical direction in camera frame (camera.cpp:305-313)
    up_con_c = np.array([0.0, 0.0, 1.0])
    if camera_pole:
        up_con_c = np.array([0.0, 1.0, 0.0])

    # Covariant metric in camera frame (camera.cpp:315-333)
    ratio = u_cov[1:] / u_cov[0]
    g_cov_c = (g_cov[1:, 1:]
               - np.outer(ratio, g_cov[1:, 0])
               - np.outer(g_cov[1:, 0], ratio)
               + np.outer(ratio, ratio) * g_cov[0, 0])

    # Vertical direction without rotation (camera.cpp:335-354)
    up_norm = float(up_con_c @ norm_cov_c)
    vert_con_c_spatial = up_con_c - up_norm * norm_con_c[1:]
    vert_cov_c = g_cov_c @ vert_con_c_spatial
    vert_norm = math.sqrt(float(vert_cov_c @ vert_con_c_spatial))
    vert_cov_c = vert_cov_c / vert_norm
    vert_con_c_spatial = vert_con_c_spatial / vert_norm

    # Horizontal = normalized cross product via the metric determinant
    # (camera.cpp:356-366)
    det_sqrt = math.sqrt(float(np.linalg.det(g_cov_c)))
    hor_con_c_spatial = np.cross(vert_cov_c, norm_cov_c) / det_sqrt

    # Apply rotation (camera.cpp:368-380)
    hor_rot = hor_con_c_spatial * crot - vert_con_c_spatial * srot
    vert_rot = vert_con_c_spatial * crot + hor_con_c_spatial * srot

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    return CameraGeometry(
        cam_x=t(cam_x), u_con=t(u_con), u_cov=t(u_cov),
        norm_con=t(norm_con), norm_con_c=t(norm_con_c),
        hor_con_c=t(np.concatenate([[0.0], hor_rot])),
        vert_con_c=t(np.concatenate([[0.0], vert_rot])),
    )


def pixel_grid(resolution: int, *, device, dtype):
    """Fractional pixel coordinates (u_ind, v_ind) (camera.cpp:393-396),
    two (resolution**2,) tensors in row-major pixel order: the camera as
    one block of ``block_pixel_grid``."""
    return block_pixel_grid([0], [0], resolution, resolution,
                            device=device, dtype=dtype)


def block_pixel_grid(block_u, block_v, block_size: int,
                     effective_resolution: int, *, device, dtype):
    """Fractional pixel coordinates of adaptive blocks (camera.cpp:
    465-499; ``blacklight_tpu/camera.py:321-343``), formed in float64 and
    rounded once, so that a block's pixel at level l has the coordinates
    of the same pixel of ``pixel_grid(resolution * 2**l)`` bit for bit.

    block_u, block_v: (B,) integer block locations at this level;
    effective_resolution: camera_resolution * 2**level.

    Returns two (B * block_size**2,) tensors, block-major then row-major
    within a block.
    """
    block_u = np.asarray(block_u)
    block_v = np.asarray(block_v)
    m = np.arange(block_size * block_size)
    m2 = m // block_size
    m1 = m % block_size
    l_offset = (block_u * block_size)[:, None]
    m_offset = (block_v * block_size)[:, None]
    res = effective_resolution
    u_ind = (m1[None, :] + l_offset - res / 2.0 + 0.5) / res
    v_ind = (m2[None, :] + m_offset - res / 2.0 + 0.5) / res
    return (torch.tensor(u_ind.reshape(-1), dtype=dtype, device=device),
            torch.tensor(v_ind.reshape(-1), dtype=dtype, device=device))


def init_pixels(geom: CameraGeometry, u_ind, v_ind, *,
                camera_type: CameraType, bh_m: float, bh_a: float,
                camera_width: float, camera_r: float,
                image_normalization: FrequencyNormalization,
                ray_flat: bool = False) -> CameraRays:
    """Pixel positions, covariant momenta and momentum factors.

    Plane camera: reference camera.cpp:528-585 (SetPixelPlane).
    Pinhole camera: reference camera.cpp:608-671 (SetPixelPinhole).
    """
    u = u_ind * bh_m * camera_width
    v = v_ind * bh_m * camera_width

    if camera_type == CameraType.plane:
        # Pixel displacement in camera frame -> coordinate frame
        d_c = u[:, None] * geom.hor_con_c[None, :] \
            + v[:, None] * geom.vert_con_c[None, :]
        dt = geom.u_con[0] * d_c[:, 0] - (
            geom.u_cov[1] * d_c[:, 1] + geom.u_cov[2] * d_c[:, 2]
            + geom.u_cov[3] * d_c[:, 3]) / geom.u_cov[0]
        dxyz = d_c[:, 1:] + geom.u_con[1:][None, :] * d_c[:, 0:1]
        positions = torch.cat([(geom.cam_x[0] + dt)[:, None],
                               geom.cam_x[1:][None, :] + dxyz], dim=-1)
        p_spatial = geom.norm_con[1:].expand(u.shape[0], 3)
    else:
        positions = geom.cam_x.expand(u.shape[0], 4).clone()
        normalization = torch.sqrt(u * u + v * v + camera_r * camera_r)
        frac_norm = camera_r / normalization
        frac_hor = -u / normalization
        frac_vert = -v / normalization
        dir_con_tc = geom.norm_con_c[0]
        dir_c = (frac_norm[:, None] * geom.norm_con_c[None, 1:]
                 + frac_hor[:, None] * geom.hor_con_c[None, 1:]
                 + frac_vert[:, None] * geom.vert_con_c[None, 1:])
        p_spatial = dir_c + geom.u_con[1:][None, :] * dir_con_tc

    # Null quadratic for p^0, then lower indices (camera.cpp:552-574)
    g_cov = geometry.gcov(positions[:, 1:], bh_a, bh_m, flat=ray_flat)
    p0 = geometry.null_momentum_time_component(g_cov, p_spatial)
    p_con = torch.cat([p0[:, None], p_spatial], dim=-1)
    # contractions by geometry.dot: the same rays in any bundle
    directions = geometry.dot(g_cov, p_con[:, None, :])

    # Momentum factor (camera.cpp:576-583)
    if image_normalization == FrequencyNormalization.camera:
        nu_local = -geometry.dot(directions, geom.u_con)
    else:
        nu_local = -directions[:, 0]
    return CameraRays(positions=positions.contiguous(),
                      directions=directions.contiguous(),
                      momentum_factors=(1.0 / nu_local).contiguous())


def make_camera(cfg, *, bh_m: float, bh_a: float, device, dtype):
    """CameraGeometry, root-level CameraRays and the frequency table from a
    Config, on ``device`` in ``dtype``."""
    geom = camera_geometry(
        bh_m=bh_m, bh_a=bh_a,
        camera_r=cfg.require("camera_r"), camera_th=cfg.require("camera_th"),
        camera_ph=cfg.require("camera_ph"),
        camera_urn=cfg.require("camera_urn"),
        camera_uthn=cfg.require("camera_uthn"),
        camera_uphn=cfg.require("camera_uphn"),
        camera_k_r=cfg.require("camera_k_r"),
        camera_k_th=cfg.require("camera_k_th"),
        camera_k_ph=cfg.require("camera_k_ph"),
        camera_rotation=cfg.require("camera_rotation"),
        camera_pole=cfg.require("camera_pole"),
        ray_flat=cfg.require("ray_flat"),
        device=device, dtype=dtype)
    u_ind, v_ind = pixel_grid(cfg.require("camera_resolution"),
                              device=device, dtype=dtype)
    rays = init_pixels(
        geom, u_ind, v_ind, camera_type=cfg.require("camera_type"),
        bh_m=bh_m, bh_a=bh_a, camera_width=cfg.require("camera_width"),
        camera_r=cfg.require("camera_r"),
        image_normalization=cfg.require("image_normalization"),
        ray_flat=cfg.require("ray_flat"))
    num_freq = cfg.require("image_num_frequencies")
    if num_freq == 1:
        freqs = image_frequency_table(1, cfg.require("image_frequency"),
                                      device=device, dtype=dtype)
    else:
        freqs = image_frequency_table(
            num_freq, 0.0, cfg.require("image_frequency_start"),
            cfg.require("image_frequency_end"),
            cfg.require("image_frequency_spacing"), device=device,
            dtype=dtype)
    return geom, rays, freqs
