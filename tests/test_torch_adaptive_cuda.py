"""PyTorch port: adaptive image-plane refinement (ROADMAP A.9) on the card.

Each level's child bundle goes through the root image's kernel. Every
level's arrays must equal, bit for bit, the same kernel's render of the
same pixels' rays taken from the finer camera (``pixel_grid(resolution *
2**level)``), launched in that camera's row-major order rather than the
level's block order: K1 (float32 in camera order, float64 in
spatial_order), K2.1, K2.3 beside K2.1 (phased dispatch of the larger
bundles, the root's image and every level bit for bit the monolithic
run's) and the K3.1 route, each also with blocks of 5, whose bundles are
a multiple of no warp.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_adaptive_cuda.py``. Without a GPU every test skips. The
levels are held against the JAX package in ``test_torch_adaptive.py``.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, pipeline, read_config
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.ops import formula_kernel as fk
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
# The criteria of golden_adaptive_32.input and a forced region over the
# centre, so that every level refines some blocks whatever the rounding
ADAPTIVE = dict(adaptive_max_level=2, adaptive_frequency_num=1,
                adaptive_rel_lapl_cut=0.5, adaptive_rel_lapl_frac=0.2,
                adaptive_num_regions=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _config(name, tmp_path, res, block, **overrides):
    from blacklight_tpu_torch.utils.config import AdaptiveRegion
    cfg = read_config(str(FIXTURES / name))
    cfg.simulation_file = str(FIXTURES / "mock_small.athdf")
    cfg.output_file = str(tmp_path / "out.npz")
    cfg.camera_resolution = res
    cfg.adaptive_block_size = block
    for key in ("val", "abs_grad", "rel_grad", "abs_lapl"):
        setattr(cfg, f"adaptive_{key}_cut", 0.0)
        setattr(cfg, f"adaptive_{key}_frac", -1.0)
    half = 0.15 * cfg.camera_width
    cfg.adaptive_regions = [AdaptiveRegion(level=2, x_min=-half, x_max=half,
                                           y_min=-half, y_max=half)]
    for key, value in {**ADAPTIVE, **overrides}.items():
        if key == "ray_integrator":
            value = RayIntegrator(value)
        setattr(cfg, key, value)
    return cfg


def _renderer(cfg):
    if cfg.model_type.value == "formula":
        return pipeline.make_formula_renderer(cfg, device="cuda")
    return pipeline_simulation.make_simulation_renderer(cfg, device="cuda")


def level_pixels(locs, block, resolution):
    """Row-major indices into a ``resolution``^2 camera of the pixels of
    blocks ``locs`` (B, 2) (v, u), block-major then row-major within a
    block, as a level's bundle holds them."""
    m = np.arange(block * block)
    rows = (locs[:, 0] * block)[:, None] + m // block
    cols = (locs[:, 1] * block)[:, None] + m % block
    return (rows * resolution + cols).reshape(-1)


def _assert_levels_are_direct_renders(cfg, arrays):
    """Every level's images bit for bit the kernel's render of the same
    pixels of the finer camera, launched in its row-major order."""
    res, block = cfg.camera_resolution, cfg.adaptive_block_size
    levels = int(arrays["adaptive_num_levels"][0])
    assert levels == cfg.adaptive_max_level
    counts = arrays["adaptive_num_blocks"]
    for level in range(1, levels + 1):
        assert 0 < counts[level] < 4 * counts[level - 1], counts
        fine = res << level
        render_fn, _, rays, _, _ = _renderer(dataclasses.replace(
            cfg, camera_resolution=fine, adaptive_max_level=0))
        pick = level_pixels(arrays[f"adaptive_block_locs_{level}"], block,
                            fine)
        order = np.argsort(pick)
        index = torch.from_numpy(pick[order]).to(rays.positions.device)
        direct = render_fn(rays.positions[index], rays.directions[index],
                           rays.momentum_factors[index])
        for key in STOKES:
            if key not in direct:
                continue
            values = direct[key][:, 0].cpu().numpy()[np.argsort(order)]
            ours = arrays[f"adaptive_{key}_{level}"]
            assert ours.shape == (counts[level], block, block)
            assert ours.dtype == values.dtype
            assert np.array_equal(ours.reshape(-1), values, equal_nan=True), \
                (key, level)


def _zero_counts():
    fk.LAUNCHES = sk.LAUNCHES = sk.PHASE_LAUNCHES = pk.LAUNCHES = 0


CASES = {
    "formula_dp_float32": ("golden_formula_32.input", 32, 8,
                           dict(ray_integrator="dp", precision="float32")),
    "formula_rk4_float64": ("golden_formula_cam_rk4_32.input", 32, 8,
                            dict(precision="float64")),
    "formula_rk4_float64_blocks_of_5": ("golden_formula_cam_rk4_32.input",
                                        20, 5, dict(precision="float64")),
    "simulation_rk4_float32": ("golden_sim_rk4_32.input", 64, 8,
                               dict(precision="float32")),
    "simulation_rk4_float32_blocks_of_5": ("golden_sim_rk4_32.input", 40, 5,
                                           dict(precision="float32")),
    "polarized_rk4_float32": ("golden_polarized_rk4_32.input", 32, 8,
                              dict(precision="float32", ray_step=0.04,
                                   ray_max_steps=400)),
    "polarized_rk4_float64_blocks_of_5": (
        "golden_polarized_rk4_32.input", 20, 5,
        dict(precision="float64", ray_step=0.04, ray_max_steps=400)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_levels_equal_direct_renders(cuda_device, tmp_path, case):
    name, res, block, overrides = CASES[case]
    cfg = _config(name, tmp_path, res, block, **overrides)
    _zero_counts()
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    launches = {"formula": fk.LAUNCHES, "simulation": sk.LAUNCHES,
                "polarized": pk.LAUNCHES}
    # every level on the kernel: at least one launch a render, none of
    # another kernel
    kind = case.split("_")[0]
    assert launches.pop(kind) >= 1 + cfg.adaptive_max_level, launches
    assert not any(launches.values()), launches
    assert sk.PHASE_LAUNCHES == 0
    _assert_levels_are_direct_renders(cfg, arrays)


def test_phased_levels_equal_the_monolithic_run(cuda_device, tmp_path,
                                                monkeypatch):
    """Phased dispatch for bundles of at least 4,096 rays (the 64^2 root
    among them): the smaller bundles go to the monolithic kernel, and
    every array is the monolithic run's bit for bit."""
    cfg = _config("golden_sim_rk4_32.input", tmp_path, 64, 8,
                  precision="float32")
    mono = pipeline.run(cfg, quiet=True, device="cuda")
    rays = [64 * 64] + [int(n) * 64 for n in mono["adaptive_num_blocks"][1:]]
    chunk = 4096
    phased = [n for n in rays if n >= chunk]
    assert 0 < len(phased) < len(rays), rays
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASED", True)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_STEPS", 256)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_CHUNK", chunk)
    _zero_counts()
    ours = pipeline.run(cfg, quiet=True, device="cuda")
    assert sk.PHASE_LAUNCHES >= len(phased)
    assert sk.LAUNCHES == len(rays) - len(phased)
    assert set(ours) == set(mono)
    for key in mono:
        assert np.array_equal(ours[key], mono[key], equal_nan=True), key
