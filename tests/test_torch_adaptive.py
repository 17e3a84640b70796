"""PyTorch port: adaptive image-plane refinement (ROADMAP A.9) against the
JAX package.

The port's copy of ``adaptive.py`` against ``blacklight_tpu.adaptive`` on
seeded images; ``camera.block_pixel_grid`` against the JAX package's and
against the finer camera's ``pixel_grid``; ``pipeline.run(cfg,
device="cpu")`` with adaptive_max_level = 2 against the JAX package's
``run``, array by array, for the formula model (rk4, float64,
test_adaptive.CONFIG) and the polarized route; and level-1 pixels against
a straight render at twice the resolution. The simulation model's cases
are in test_torch_adaptive_simulation.py.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import adaptive as jax_ad
from blacklight_tpu import camera as jax_camera
from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import (BlacklightError, adaptive, camera,
                                  parse_config, pipeline)

from test_adaptive import CONFIG

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
# Polarized channels: rtol over a floor of 1e-4 of the channel's peak, as
# tests/test_torch_polarized_pipeline.py holds the polarized run (V is
# amplified by the Faraday rotation, ROADMAP §3)
POL_RTOL = {"I_nu": 1e-8, "Q_nu": 1e-8, "U_nu": 1e-8, "V_nu": 1e-5}


# (a) adaptive.py against the JAX package's

def _params(**criteria):
    return (adaptive.AdaptiveParams(max_level=2, block_size=6, **criteria),
            jax_ad.AdaptiveParams(max_level=2, block_size=6, **criteria))


def _blocks(seed, n=40, bs=6):
    """Seeded block images: smooth, noisy, flat, all-NaN and part-NaN
    blocks."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:bs, 0:bs] / bs
    blocks = np.exp(rng.normal(size=(n, 1, 1)) * 2.0) * (
        1.0 + rng.uniform(0.0, 3.0, (n, 1, 1)) * x * y
        + rng.uniform(0.0, 0.5, (n, bs, bs)) * (rng.uniform(size=(n, 1, 1))
                                                > 0.5))
    blocks[1] = 1.0
    blocks[2] = np.nan
    blocks[3, :2] = np.nan
    blocks[4, ::2, 1::2] = np.nan
    return blocks


CRITERIA = {
    "value": dict(val_cut=1.5, val_frac=0.3),
    "abs_grad": dict(abs_grad_cut=0.4, abs_grad_frac=0.2),
    "rel_grad": dict(rel_grad_cut=0.3, rel_grad_frac=0.1),
    "abs_lapl": dict(abs_lapl_cut=0.2, abs_lapl_frac=0.1),
    "rel_lapl": dict(rel_lapl_cut=0.2, rel_lapl_frac=0.05),
    "all": dict(val_cut=8.0, val_frac=0.5, abs_grad_cut=2.0,
                abs_grad_frac=0.5, rel_grad_cut=0.6, rel_grad_frac=0.4,
                abs_lapl_cut=1.0, abs_lapl_frac=0.3, rel_lapl_cut=0.5,
                rel_lapl_frac=0.3),
    "none": {},
}


@pytest.mark.parametrize("criterion", sorted(CRITERIA))
def test_evaluate_blocks_matches_jax(criterion):
    ours_p, ref_p = _params(**CRITERIA[criterion])
    for seed in range(3):
        blocks = _blocks(seed)
        with np.errstate(invalid="ignore", divide="ignore"):
            ours = adaptive.evaluate_blocks(blocks, ours_p)
            ref = jax_ad.evaluate_blocks(blocks, ref_p)
        assert ours.dtype == ref.dtype == bool
        np.testing.assert_array_equal(ours, ref)
        if criterion == "none":
            assert not ours.any()
        elif criterion != "all":
            assert 0 < ours.sum() < ours.size, (criterion, ours.sum())
    # NaN entries are not examined: the all-NaN block never refines, the
    # part-NaN one by its finite entries alone
    if criterion != "none":
        assert not ours[2]


def test_nan_excluded_like_jax():
    ours_p, ref_p = _params(val_cut=1.0, val_frac=0.4)
    blocks = np.full((2, 6, 6), np.nan)
    blocks[0, 0, :2] = 2.0
    blocks[1, 0, :2] = 0.5
    flags = adaptive.evaluate_blocks(blocks, ours_p)
    assert flags.tolist() == [True, False]
    np.testing.assert_array_equal(flags,
                                  jax_ad.evaluate_blocks(blocks, ref_p))


def test_forced_flags_and_refinement_match_jax():
    regions = ((1, -6.0, 6.0, -6.0, 6.0), (3, -20.0, -2.0, 1.0, 9.0),
               (0, -30.0, 30.0, -30.0, 30.0))
    ours_p, ref_p = _params(val_cut=1.5, val_frac=0.3, regions=regions)
    rng = np.random.default_rng(7)
    for level in range(3):
        linear = 4 << level
        locs = rng.integers(0, linear, (40, 2)).astype(np.int32)
        forced = adaptive.forced_flags(locs, level, linear, 25.0, ours_p)
        np.testing.assert_array_equal(
            forced, jax_ad.forced_flags(locs, level, linear, 25.0, ref_p))
        blocks = _blocks(level)
        flags = adaptive.check_refinement(blocks, locs, level, 24, 25.0,
                                          ours_p)
        np.testing.assert_array_equal(flags, jax_ad.check_refinement(
            blocks, locs, level, 24, 25.0, ref_p))
        assert (flags | ~forced).all()
        if level < 2:
            assert forced.any()
        children = adaptive.child_block_locs(locs, flags)
        np.testing.assert_array_equal(children,
                                      jax_ad.child_block_locs(locs, flags))
        assert children.dtype == np.int32
        assert children.shape == (4 * flags.sum(), 2)


def test_block_extraction_matches_jax():
    rng = np.random.default_rng(3)
    res, bs = 24, 6
    image = rng.normal(size=res * res)
    np.testing.assert_array_equal(adaptive.root_block_locs(res, bs),
                                  jax_ad.root_block_locs(res, bs))
    np.testing.assert_array_equal(
        adaptive.extract_root_blocks(image, res, bs),
        jax_ad.extract_root_blocks(image, res, bs))
    np.testing.assert_array_equal(
        adaptive.blocks_from_bundle(image, 16, bs),
        jax_ad.blocks_from_bundle(image, 16, bs))


REGIONS = """
adaptive_region_1_level = 2
adaptive_region_1_x_min = -6.0
adaptive_region_1_x_max = 6.0
adaptive_region_1_y_min = -6.0
adaptive_region_1_y_max = 2.0
adaptive_region_2_level = 1
adaptive_region_2_x_min = 3.0
adaptive_region_2_x_max = 12.0
adaptive_region_2_y_min = -12.0
adaptive_region_2_y_max = 0.0
"""


def _set(text, settings):
    """``text`` with each key's line set to ``settings``' value (appended
    where the text has none)."""
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _formula_text(out, res=16, max_level=2, regions=REGIONS, **overrides):
    """test_adaptive.CONFIG at ``res``^2 with ``max_level`` levels, two
    forced regions, and ``overrides``."""
    return _set(CONFIG.format(out=str(out), res=res, max_level=max_level,
                              num_regions=regions.count("_level"),
                              regions=regions), overrides)


def test_params_from_config_match_jax(tmp_path):
    text = _formula_text(tmp_path / "o.npz", adaptive_abs_grad_frac=0.1,
                         adaptive_rel_lapl_frac=0.2)
    ours = adaptive.AdaptiveParams.from_config(parse_config(text))
    ref = jax_ad.AdaptiveParams.from_config(jax_parse_config(text))
    assert ours.regions == ref.regions and len(ours.regions) == 2
    assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    off = adaptive.AdaptiveParams.from_config(
        parse_config(_formula_text(tmp_path / "o.npz", max_level=0)))
    assert off == adaptive.AdaptiveParams()


def test_block_size_error_matches_jax(tmp_path):
    text = _formula_text(tmp_path / "o.npz", res=20)
    with pytest.raises(Exception) as ref:
        jax_ad.AdaptiveParams.from_config(jax_parse_config(text))
    with pytest.raises(BlacklightError) as ours:
        adaptive.AdaptiveParams.from_config(parse_config(text))
    assert str(ours.value) == str(ref.value) == (
        "adaptive_block_size must divide camera_resolution.")


# (b) block_pixel_grid

def level_pixels(locs, block, resolution):
    """Row-major indices into a ``resolution``^2 camera of the pixels of
    blocks ``locs`` (B, 2) (v, u), block-major then row-major within a
    block, as a level's bundle holds them."""
    m = np.arange(block * block)
    rows = (locs[:, 0] * block)[:, None] + m // block
    cols = (locs[:, 1] * block)[:, None] + m % block
    return (rows * resolution + cols).reshape(-1)



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_pixel_grid_matches_jax_and_the_finer_camera(dtype):
    rng = np.random.default_rng(11)
    bs, res, level = 5, 20, 2
    eff = res << level
    locs = rng.choice((eff // bs) ** 2, 23, replace=False)
    block_v, block_u = np.divmod(locs, eff // bs)
    u, v = camera.block_pixel_grid(block_u, block_v, bs, eff, device="cpu",
                                   dtype=dtype)
    assert u.dtype == v.dtype == dtype and u.shape == (23 * bs * bs,)
    if dtype == torch.float64:
        ju, jv = jax_camera.block_pixel_grid(block_u, block_v, bs, eff)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # the same pixels of the finer camera's grid, bit for bit
    pick = torch.from_numpy(level_pixels(np.stack([block_v, block_u], -1),
                                         bs, eff))
    fu, fv = camera.pixel_grid(eff, device="cpu", dtype=dtype)
    assert torch.equal(u, fu[pick]) and torch.equal(v, fv[pick])
    # and so are their rays
    cfg = parse_config(_formula_text("o.npz", res=eff))
    cfg.precision = "float32" if dtype == torch.float32 else "float64"
    _, geom, fine, _ = pipeline.make_formula_renderer(cfg, device="cpu")[:4]
    rays = camera.init_pixels(
        geom, u, v, camera_type=cfg.camera_type, bh_m=1.0,
        bh_a=cfg.formula_spin, camera_width=cfg.camera_width,
        camera_r=cfg.camera_r, image_normalization=cfg.image_normalization)
    for name in ("positions", "directions", "momentum_factors"):
        assert torch.equal(getattr(rays, name), getattr(fine, name)[pick])


# (c) run against the JAX package's run

def _assert_same_arrays(ours, ref, rtol=1e-8, pol_rtol=None):
    """Every array of ``ref`` in ``ours``, integers equal, floats with
    equal NaN sets within ``rtol`` (entries zero up to rounding, the
    camera's t = 0, within 1e-14 of the peak); Stokes channels of a
    polarized run by ``pol_rtol``."""
    assert set(ours.keys()) == set(ref.keys())
    for key in ref.keys():
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape, key
        if a.dtype.kind != "f":
            assert np.array_equal(a, b), key
            continue
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        channel = re.sub(r"^adaptive_|_\d+$", "", key)
        if pol_rtol and channel in pol_rtol:
            floor = np.nanmax(np.abs(b)) * 1e-4
            rel = np.abs(a - b) / (np.abs(b) + floor)
            assert np.nanmax(rel) < pol_rtol[channel], (key, np.nanmax(rel))
            continue
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=1e-14 * np.nanmax(np.abs(b)),
                                   err_msg=key)


def _assert_refines(arrays, levels=2):
    """``levels`` levels, each refining some but not every block of the
    level above."""
    counts = arrays["adaptive_num_blocks"]
    assert arrays["adaptive_num_levels"][0] == levels == len(counts) - 1
    for level in range(1, levels + 1):
        assert 0 < counts[level] < 4 * counts[level - 1], counts
        locs = arrays[f"adaptive_block_locs_{level}"]
        assert locs.shape == (counts[level], 2)
        assert arrays[f"adaptive_I_nu_{level}"].shape[0] == counts[level]


def _run_both(tmp_path, text):
    ref = jax_pipeline.run(jax_parse_config(
        text.replace(str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz"))),
        quiet=True)
    ours = pipeline.run(parse_config(text), quiet=True, device="cpu")
    written = np.load(tmp_path / "torch.npz")
    assert set(written.keys()) == set(ours.keys())
    for key in ours:
        np.testing.assert_array_equal(written[key], ours[key])
    return ours, ref, np.load(tmp_path / "jax.npz")


def test_formula_run_matches_jax(tmp_path):
    """rk4 float64 with output_camera: every level's image and camera
    positions. rtol 1e-7, tests/test_formula_e2e.py's gate for rk4: at
    the second level's 64^2 pixels torch and XLA part by up to 3.6e-8 on
    photon-ring rays, as a straight 64^2 render of both packages does."""
    text = _formula_text(tmp_path / "torch.npz", output_camera="true",
                         adaptive_block_size=4, adaptive_val_cut=1.0e-4)
    ours, ref, ref_file = _run_both(tmp_path, text)
    _assert_refines(ours)
    assert "adaptive_positions_2" in ours
    _assert_same_arrays(ours, ref, rtol=1e-7)
    _assert_same_arrays(np.load(tmp_path / "torch.npz"), ref_file, rtol=1e-7)


def _sim_text(out, name="golden_adaptive_32.input", **overrides):
    """``name`` at 16^2 with 300 steps of 0.03, two levels of blocks of 4
    by golden_adaptive_32's Laplacian criterion at a cut of 1, and
    ``overrides``."""
    return _set((FIXTURES / name).read_text(), {
                "output_file": out, "camera_resolution": 16,
                "ray_step": 0.03, "ray_max_steps": 300,
                "adaptive_max_level": 2, "adaptive_block_size": 4,
                "adaptive_frequency_num": 1, "adaptive_val_cut": 0.0,
                "adaptive_val_frac": -1.0, "adaptive_abs_grad_cut": 0.0,
                "adaptive_abs_grad_frac": -1.0, "adaptive_rel_grad_cut": 0.0,
                "adaptive_rel_grad_frac": -1.0, "adaptive_abs_lapl_cut": 0.0,
                "adaptive_abs_lapl_frac": -1.0, "adaptive_rel_lapl_cut": 1.0,
                "adaptive_rel_lapl_frac": 0.2, "adaptive_num_regions": 0,
                **overrides})


def test_polarized_run_matches_jax(tmp_path):
    """golden_polarized_rk4_32.input on mock_small.athdf at 8^2 with 400
    steps of 0.04 (tests/test_torch_polarized_pipeline.py's run), two
    levels of blocks of 4 refined by Stokes I."""
    text = _sim_text(tmp_path / "torch.npz",
                     name="golden_polarized_rk4_32.input",
                     simulation_file=FIXTURES / "mock_small.athdf",
                     camera_resolution=8, ray_step=0.04, ray_max_steps=400,
                     adaptive_rel_lapl_cut=3.0)
    ours, ref, ref_file = _run_both(tmp_path, text)
    _assert_refines(ours)
    assert ours["adaptive_V_nu_2"].shape == ours["adaptive_I_nu_2"].shape
    _assert_same_arrays(ours, ref, pol_rtol=POL_RTOL)
    _assert_same_arrays(np.load(tmp_path / "torch.npz"), ref_file,
                        pol_rtol=POL_RTOL)


# (d) the levels' pixels against a straight render of the finer camera

def test_level_pixels_equal_a_straight_render(tmp_path):
    """The port's test_adaptive_run_refines_and_matches_direct_render:
    level-1 pixels are the same pixels of a straight render at twice the
    resolution, bit for bit (the child rays are the finer camera's)."""
    text = _formula_text(tmp_path / "a.npz", max_level=1,
                         regions=REGIONS.replace("level = 2", "level = 1"),
                         adaptive_val_frac=-1.0)
    arrays = pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert arrays["adaptive_num_levels"][0] == 1
    n_blocks = arrays["adaptive_num_blocks"][1]
    assert 0 < n_blocks < 4 * 4
    straight = pipeline.run(parse_config(_formula_text(
        tmp_path / "b.npz", res=32, max_level=0)), quiet=True,
        device="cpu")["I_nu"]
    level = arrays["adaptive_I_nu_1"]
    assert level.shape == (n_blocks, 8, 8)
    pick = level_pixels(arrays["adaptive_block_locs_1"], 8, 32)
    np.testing.assert_array_equal(level.reshape(-1),
                                  straight.reshape(-1)[pick])
