"""PyTorch port: phased dispatch of the simulation kernel (K2.3) and the
ray orderings of the kernel routes, against the JAX package and the
port's own monolithic plain version.

golden_sim_rk4_32.input on mock_small.athdf at 16^2 with 110 steps of
0.08 (test_torch_simulation_pipeline.py's 300 of 0.03, cut for time:
most rays still end inside the budget), phases of 26 steps so that five
phases run and three of them drop finished rays and re-tile the
survivors. On the CPU every route runs the plain version; the card's
bit-for-bit gates are in test_torch_simulation_phased_cuda.py. Between
two plain runs a permuted or compacted bundle need not round alike: torch
evaluates a transcendental's vectorized and tail elements differently,
hence rtol 1e-12 in float64 and the statistical gate in float32.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu.ops import pallas_simulation as jax_psim
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import parse_config, pipeline, pipeline_simulation
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
MAX_STEPS = 110
PHASE_STEPS = 26


def _config_text(out, res=16, name="golden_sim_rk4_32.input", **overrides):
    """``name`` on mock_small.athdf at ``res``^2 with MAX_STEPS steps of
    0.08, and ``overrides`` (key = value, as in an input file)."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": out, "camera_resolution": res,
                "ray_step": 0.08, "ray_max_steps": MAX_STEPS, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _renderer(tmp_path, **overrides):
    cfg = parse_config(_config_text(tmp_path / "out.npz", **overrides))
    return pipeline_simulation.make_simulation_renderer(cfg, device="cpu")


def _args(render_fn, rays, n=None):
    """render_simulation's arguments on the camera rays (the first n)."""
    return (*(t[:n].contiguous() for t in (
        rays.positions, rays.directions, rays.momentum_factors)),
        *render_fn.kernel_args)


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels
    past 1e-3 relative, total flux within 1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))


def _assert_exact(ours, ref, rtol=1e-12):
    """Identical flags, n_samples and NaN sets, I_nu within rtol."""
    a, b = ours[0].numpy(), ref[0].numpy()
    assert torch.equal(ours[1], ref[1]) and torch.equal(ours[2], ref[2])
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(b) > 0.0 and np.isfinite(b).mean() > 0.5
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(render_fn, rays, the monolithic plain render in camera order) at
    8^2 with 60 steps, rk4 float64, no NaN poisoning."""
    render_fn, _, rays, _, _ = _renderer(tmp_path_factory.mktemp("small"),
                                         res=8, ray_max_steps=60,
                                         fallback_nan="false")
    ref = sk.render_simulation_reference(*_args(render_fn, rays),
                                         integrator="rk4")
    return render_fn, rays, ref


# (a) the orderings against the JAX package's

def _positions(case, dtype):
    """Seeded positions (B, 4): a spread cloud, or one with an axis that
    spans nothing (z = 0: cos theta of angular_order; x^2 and x^3 fixed:
    the second camera-plane axis of spatial_order), or one ray."""
    rng = np.random.default_rng(7)
    n = {"cloud": 5000, "prime": 3001, "one": 1}.get(case, 777)
    pos = rng.normal(size=(n, 4)) * [1.0, 10.0, 3.0, 7.0]
    if case == "equator":
        pos[:, 3] = 0.0
    elif case == "line":
        pos[:, 2], pos[:, 3] = 0.5, -2.0
    return pos.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case, block", [
    ("cloud", 1024), ("prime", 128), ("one", 1024), ("equator", 64),
    ("line", 64)])
@pytest.mark.parametrize("name", ["spatial_order", "angular_order"])
def test_orderings_match_jax(name, case, block, dtype):
    """The port's permutation is the JAX package's on the same seeded
    numpy positions. The float32 keys come from float32 arithmetic on
    both sides; a value within an ulp of a bin edge could fall on either
    side, and these inputs have none that does."""
    pos = _positions(case, np.dtype(dtype))
    ref = getattr(jax_psim, name)(pos, block=block)
    ours = getattr(sk, name)(torch.from_numpy(pos), block=block)
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), ref)


# (b) the plain phased render against the plain monolithic one

def _phased(args, integrator, stats):
    return sk.render_simulation_phased(*args, integrator=integrator,
                                       phase_steps=PHASE_STEPS, block=16,
                                       stats=stats)


def _assert_phases_compacted(stats, n_rays):
    """Five phases; the pool shrinks in at least three of them and the
    last ends it."""
    assert len(stats) == -(-MAX_STEPS // PHASE_STEPS)
    assert stats[0]["rays"] == n_rays
    assert sum(s["survivors"] < s["rays"] for s in stats) >= 3
    assert stats[-1]["survivors"] == 0
    for s, following in zip(stats, stats[1:]):
        assert following["rays"] == s["survivors"]


def test_plain_phased_matches_monolithic_rk4_float64(tmp_path):
    render_fn, _, rays, _, _ = _renderer(tmp_path)
    args = _args(render_fn, rays)
    ref = sk.render_simulation_reference(*args, integrator="rk4")
    stats = []
    ours = _phased(args, "rk4", stats)
    _assert_phases_compacted(stats, 256)
    _assert_exact(ours, ref)


def test_plain_phased_matches_monolithic_rk2_float32(tmp_path):
    """251 rays: a bundle that is a multiple of no block or warp."""
    render_fn, _, rays, _, _ = _renderer(tmp_path, ray_integrator="rk2",
                                         precision="float32")
    args = _args(render_fn, rays, 251)
    ref = sk.render_simulation_reference(*args, integrator="rk2")
    stats = []
    ours = _phased(args, "rk2", stats)
    _assert_phases_compacted(stats, 251)
    assert torch.equal(ours[1], ref[1]) and torch.equal(ours[2], ref[2])
    _statistical_gate(ours[0][:, 0].numpy(), ref[0][:, 0].numpy())


def test_plain_phased_many_frequencies(tmp_path):
    """18 frequencies: two rows of bad bits and of accumulators, and the
    NaN poisoning of samples off the grid (fallback_nan)."""
    render_fn, _, rays, freqs, _ = _renderer(
        tmp_path, res=4, ray_max_steps=60, ray_step=0.1,
        image_num_frequencies=18, image_frequency_start=1e11,
        image_frequency_end=6e11, image_frequency_spacing="log")
    args = _args(render_fn, rays)
    ref = sk.render_simulation_reference(*args, integrator="rk4")
    ours = sk.render_simulation_phased(*args, integrator="rk4",
                                       phase_steps=16)
    assert ref[0].shape == (16, 18)
    assert torch.equal(ours[1], ref[1]) and torch.equal(ours[2], ref[2])
    assert np.array_equal(ours[0].isnan().numpy(), ref[0].isnan().numpy())
    np.testing.assert_allclose(ours[0].numpy(), ref[0].numpy(), rtol=1e-12)


def test_phase_from_carried_state(small):
    """Two phases through render_simulation_phase and finish_rays give
    the monolithic render of their 60-step budget: the carried state
    holds everything the loop needs."""
    render_fn, rays, ref = small
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js \
        = _args(render_fn, rays)
    carry = sk.initial_carry(positions, directions, params, 1)
    index = torch.arange(64, dtype=torch.int32)
    for n_base in (0, 32):
        sk.render_simulation_phase(carry, index, n_base, 32, directions, mom,
                                   freqs, params, sp, grid, mass, cam,
                                   integrator="rk4")
    assert int(carry.n_samp.min()) == 60
    ours = sk.finish_rays(carry, index, freqs, log_js, False)
    _assert_exact(ours, ref)


# (c) the slice as a whole: the port's phased run against the JAX run

@pytest.fixture
def phased_route(monkeypatch):
    """KERNEL_PHASED on, phases of PHASE_STEPS, any bundle size; counts
    the calls of render_simulation_phased."""
    calls = []
    phased = sk.render_simulation_phased

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return phased(*args, **kwargs)

    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASED", True)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_STEPS",
                        PHASE_STEPS)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_CHUNK", 1)
    monkeypatch.setattr(sk, "render_simulation_phased", spy)
    return calls


def test_phased_run_matches_jax_run(tmp_path, phased_route):
    text = _config_text(tmp_path / "jax.npz", output_camera="true")
    ref = jax_pipeline.run(jax_parse_config(text), quiet=True)
    cfg = parse_config(_config_text(tmp_path / "torch.npz",
                                    output_camera="true"))
    ours = pipeline.run(cfg, quiet=True, device="cpu")
    assert len(phased_route) == 1
    assert phased_route[0]["phase_steps"] == PHASE_STEPS
    for arrays in (ours, np.load(tmp_path / "torch.npz")):
        assert set(arrays.keys()) == set(ref.keys())
        for key in ref.keys():
            a, b = np.asarray(arrays[key]), np.asarray(ref[key])
            assert a.shape == b.shape, key
            if a.dtype.kind == "f":
                assert np.array_equal(np.isnan(a), np.isnan(b)), key
                atol = 1e-14 * np.nanmax(np.abs(b))
                np.testing.assert_allclose(a, b, rtol=1e-8, atol=atol,
                                           err_msg=key)
            else:
                assert np.array_equal(a, b), key


# (d) routing

@pytest.mark.parametrize("integrator, max_steps, n_rays, phased", [
    ("rk4", 65, 256, True), ("rk2", 300, 256, True),
    ("dp", 300, 256, False), ("rk4", 64, 256, False),
    ("rk4", 300, 255, False)])
def test_use_phased(monkeypatch, integrator, max_steps, n_rays, phased):
    """JAX's condition: rk4/rk2, a step budget longer than a phase, and a
    bundle of at least KERNEL_PHASE_CHUNK rays; never while
    KERNEL_PHASED is off."""
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_STEPS", 64)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_CHUNK", 256)
    assert not pipeline_simulation.use_phased(integrator, max_steps, n_rays)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASED", True)
    assert pipeline_simulation.use_phased(integrator, max_steps,
                                          n_rays) == phased


@pytest.mark.parametrize("overrides, phased", [
    ({}, True), ({"ray_integrator": "dp"}, False),
    ({"ray_max_steps": PHASE_STEPS}, False)])
def test_run_takes_the_route(tmp_path, phased_route, overrides, phased):
    """rk4 with a budget of two phases takes phased dispatch; dp, or a
    budget of one phase, the monolithic kernel."""
    cfg = parse_config(_config_text(tmp_path / "out.npz", res=4,
                                    **{"ray_max_steps": 2 * PHASE_STEPS,
                                       **overrides}))
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    assert arrays["I_nu"].shape == (4, 4)
    assert len(phased_route) == int(phased)


def test_phase_refuses_dp(small):
    render_fn, rays, _ = small
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js \
        = _args(render_fn, rays)
    carry = sk.initial_carry(positions, directions, params, 1)
    index = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="rk4 and rk2 only"):
        sk.render_simulation_phase(carry, index, 0, 64, directions, mom,
                                   freqs, params, sp, grid, mass, cam,
                                   integrator="dp")
    with pytest.raises(ValueError, match="rk4 and rk2 only"):
        sk.render_simulation_phased(positions, directions, mom, freqs,
                                    params, sp, grid, mass, cam, log_js,
                                    integrator="dp")
    with pytest.raises(TypeError, match="int32"):
        sk.render_simulation_phase(carry, index.long(), 0, 64, directions,
                                   mom, freqs, params, sp, grid, mass, cam)


# (e) the spatial_order routes leave the image as it was

def test_ordered_route_keeps_the_image(small):
    render_fn, rays, ref = small
    ours = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    order = sk.spatial_order(
        rays.positions, block=pipeline_simulation.KERNEL_ORDER_BLOCK)
    assert not torch.equal(order, torch.arange(64))
    _assert_exact((ours["I_nu"], ours["_flags"], ours["_n_samples"]), ref)


def test_ordered_polarized_route_keeps_the_image(tmp_path):
    """4^2 rays, 15 steps of 0.04 without NaN poisoning: the camera-frame
    Stokes of render_fn against render_polarized in camera order."""
    render_fn, geom, rays, freqs, _ = _renderer(
        tmp_path, res=4, name="golden_polarized_rk4_32.input",
        ray_step=0.04, ray_max_steps=15, fallback_nan="false")
    ours = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    args = _args(render_fn, rays)
    nn_re, nn_im, flags, n_samples, bad = pk.render_polarized_reference(
        *args, **render_fn.kernel_kwargs)
    ref = pk.poisoned_stokes(nn_re, nn_im, flags, bad, args[0], args[1],
                             freqs, args[4], geom, args[-1], False)
    assert torch.equal(ours["_flags"], flags)
    assert torch.equal(ours["_n_samples"], n_samples)
    assert int(n_samples.min()) > 0
    for key, value in ref.items():
        a, b = ours[key].numpy(), value.numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        assert np.isfinite(b).any(), key
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0, err_msg=key)
