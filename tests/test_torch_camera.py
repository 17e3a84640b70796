"""PyTorch port: camera rays against the JAX package's make_camera."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu import read_config
from blacklight_tpu.camera import make_camera as jax_make_camera
from blacklight_tpu_torch import interop
from blacklight_tpu_torch.camera import init_pixels, make_camera, pixel_grid

torch.set_num_threads(2)

RTOL = 1e-12

# (fixture, overrides): plane and pinhole cameras, plus the pole-on and
# flat-space branches of the camera frame
CASES = {
    "plane": ("golden_formula_cam_32.input", {}),
    "pinhole": ("golden_pinhole_32.input", {}),
    "plane_pole": ("golden_formula_cam_32.input",
                   {"camera_th": 0.0, "camera_pole": True}),
    "pinhole_flat": ("golden_pinhole_32.input", {"ray_flat": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_camera_matches_jax(fixtures_dir, case):
    name, overrides = CASES[case]
    cfg = read_config(str(fixtures_dir / name))
    cfg.camera_resolution = 16
    for k, v in overrides.items():
        setattr(cfg, k, v)
    spin = 0.9
    geom_j, rays_j, freqs_j = jax_make_camera(cfg, bh_m=1.0, bh_a=spin,
                                              dtype=jnp.float64)
    geom_t, rays_t, freqs_t = make_camera(cfg, bh_m=1.0, bh_a=spin,
                                          device="cpu", dtype=torch.float64)
    assert rays_t.positions.shape == (256, 4)
    for field in ("positions", "directions", "momentum_factors"):
        np.testing.assert_allclose(getattr(rays_t, field).numpy(),
                                   np.asarray(getattr(rays_j, field)),
                                   rtol=RTOL, atol=1e-12)
    for field in ("cam_x", "u_con", "u_cov", "norm_con", "norm_con_c",
                  "hor_con_c", "vert_con_c"):
        np.testing.assert_allclose(getattr(geom_t, field).numpy(),
                                   np.asarray(getattr(geom_j, field)),
                                   rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(freqs_t.numpy(), np.asarray(freqs_j))


def test_init_pixels_from_jax_geometry(fixtures_dir):
    """The per-pixel chain alone: the JAX camera frame carried across by
    interop gives the JAX package's rays."""
    cfg = read_config(str(fixtures_dir / "golden_formula_cam_32.input"))
    cfg.camera_resolution = 16
    geom_j, rays_j, _ = jax_make_camera(cfg, bh_m=1.0, bh_a=0.9,
                                        dtype=jnp.float64)
    geom_t = interop.camera_geometry_from_numpy(geom_j, device="cpu",
                                                dtype=torch.float64)
    u_ind, v_ind = pixel_grid(16, device="cpu", dtype=torch.float64)
    rays_t = init_pixels(
        geom_t, u_ind, v_ind, camera_type=cfg.camera_type, bh_m=1.0,
        bh_a=0.9, camera_width=cfg.camera_width, camera_r=cfg.camera_r,
        image_normalization=cfg.image_normalization, ray_flat=cfg.ray_flat)
    for field in ("positions", "directions", "momentum_factors"):
        np.testing.assert_allclose(getattr(rays_t, field).numpy(),
                                   np.asarray(getattr(rays_j, field)),
                                   rtol=RTOL, atol=1e-12)


def test_make_camera_float32_device_and_dtype(fixtures_dir):
    cfg = read_config(str(fixtures_dir / "golden_formula_32.input"))
    cfg.camera_resolution = 8
    geom, rays, freqs = make_camera(cfg, bh_m=1.0, bh_a=0.9, device="cpu",
                                    dtype=torch.float32)
    for t in (geom.cam_x, rays.positions, rays.directions,
              rays.momentum_factors, freqs):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert rays.positions.is_contiguous() and rays.directions.is_contiguous()
