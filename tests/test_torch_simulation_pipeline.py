"""PyTorch port: the simulation model's plain kernel version and its
pipeline against the JAX package on the mock Athena++ snapshot.

On the CPU the JAX renderer never takes its Pallas kernel, so the JAX
side is its exact XLA path. Images are 16^2 with at most 300 steps (ray
step 0.03, so that most rays end inside the budget). rk4 and rk2 in
float64 keep identical flags and sample counts at rtol 1e-8; dp in
float64 and rk4 in float32 are held to the statistical gate of
bench.py:181-186. dp in float32 is left to the card, against the plain
version: between torch and XLA a rounding difference changes its step
sequence, and on a trilinear grid the one-sample-per-step quadrature
moves the image by ~3e-3 with it (59 % of 32^2 pixels past 1e-3).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import pipeline_simulation as jax_sim
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import (BlacklightError, cli, interop,
                                  parse_config, pipeline, pipeline_simulation)
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CSRC = pathlib.Path(sk.__file__).resolve().parent.parent / "csrc"
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}


def _config_text(out, res=16, **overrides):
    """golden_sim_rk4_32.input on mock_small.athdf at ``res``^2 with 300
    steps of 0.03, and ``overrides`` (key = value, as in an input file)."""
    text = (FIXTURES / "golden_sim_rk4_32.input").read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": out, "camera_resolution": res,
                "ray_step": 0.03, "ray_max_steps": 300, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _config(tmp_path, **overrides):
    return parse_config(_config_text(tmp_path / "out.npz", **overrides))


def _jax_config(tmp_path, **overrides):
    return jax_parse_config(_config_text(tmp_path / "out.npz", **overrides))


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels
    past 1e-3 relative, total flux within 1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))


# name -> (input overrides, gate)
CASES = {
    "rk4": ({}, "exact"),
    "rk2_cuts_no_fallback_nan": (
        {"ray_integrator": "rk2", "fallback_nan": "false",
         "cut_omit_near": "true", "cut_rho_min": 1e-22,
         "cut_theta_e_max": 50.0, "fallback_rho": 1e-4}, "exact"),
    "rk4_three_frequencies_use_u": (
        {"image_num_frequencies": 3, "image_frequency_start": 1e11,
         "image_frequency_end": 6e11, "image_frequency_spacing": "log",
         "plasma_use_p": "false", "plasma_gamma": 1.4444444444444444,
         "plasma_gamma_i": 1.6666666666666667,
         "plasma_gamma_e": 1.3333333333333333, "simulation_a": 0.5},
        "exact"),
    "dp": ({"ray_integrator": "dp"}, "statistical"),
    "rk4_float32": ({"precision": "float32"}, "statistical"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax_xla_path(tmp_path, case):
    """render_simulation_reference on the JAX package's own camera rays."""
    overrides, gate = CASES[case]
    cfg = _config(tmp_path, **overrides)
    jrender, geom, rays, freqs, _ = jax_sim.make_simulation_renderer(
        _jax_config(tmp_path, **overrides))
    ref = jrender(rays.positions, rays.directions, rays.momentum_factors)
    precision = cfg.precision or "float64"
    render_fn, *_ = pipeline_simulation.make_simulation_renderer(
        cfg, device="cpu")
    t = interop.camera_rays_from_numpy(
        rays.positions, rays.directions, rays.momentum_factors,
        device="cpu", dtype=TORCH_DTYPE[precision])
    before = sk.LAUNCHES
    ours = render_fn(t.positions, t.directions, t.momentum_factors)
    assert sk.LAUNCHES == before  # the CPU runs the plain version
    n_freq = np.asarray(freqs).shape[0]
    assert ours["I_nu"].shape == (256, n_freq)
    assert ours["I_nu"].dtype == TORCH_DTYPE[precision]
    a = ours["I_nu"].numpy()
    b = np.asarray(ref["I_nu"]).reshape(256, n_freq)
    assert np.nanmax(b) > 0.0 and np.isfinite(b).mean() > 0.5
    if gate == "exact":
        assert np.array_equal(ours["_flags"].numpy(),
                              np.asarray(ref["_flags"]))
        assert np.array_equal(ours["_n_samples"].numpy(),
                              np.asarray(ref["_n_samples"]))
        assert np.array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0.0)
    else:
        for f in range(n_freq):
            _statistical_gate(a[:, f], b[:, f])


def test_kernel_param_order_matches_header():
    """PARAM_NAMES is the enum of csrc/simulation_params.cuh, in order."""
    header = (CSRC / "simulation_params.cuh").read_text()
    enum = re.search(r"enum SimulationParam : int \{(.*?)\};", header,
                     re.S).group(1)
    names = [n.strip()[2:] for n in re.sub(r"//[^\n]*", "", enum).split(",")
             if n.strip()]
    assert names[-1] == "COUNT"
    assert tuple(names[:-1]) == sk.PARAM_NAMES


def test_kernel_params_fold_in_float64(tmp_path):
    cfg = _config(tmp_path, cut_sigma_max=1.0, cut_b_min=-1.0)
    render_fn, geom, rays, freqs, mass_msun = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cpu")
    _, params, sp, grid, mass, camera_x, log_js = render_fn.kernel_args
    values = dict(zip(sk.PARAM_NAMES, sk.kernel_params(
        params, sp, float(freqs[0]), mass, camera_x)))
    assert values["SIGMA_MAX"] == 1.0 and values["B_MIN"] == -1.0
    assert values["USE_P"] == 1.0 and values["FALLBACK_NAN"] == 1.0
    assert values["MAX_STEPS"] == 300.0
    assert values["CAM_X1"] == camera_x[1]


def test_kernel_tables(tmp_path):
    """The (n_b, n_k, n_j, n_i, 8) primitive table and the coordinate
    rows that the CUDA kernel reads."""
    grid = pipeline_simulation.load_grid(_config(tmp_path), device="cpu",
                                         dtype=torch.float64)
    table, coords = sk.kernel_tables(grid, torch.float64)
    nvar, _, n_k, n_j, n_i = grid.prim.shape
    assert table.shape == (1, n_k, n_j, n_i, 8) and table.is_contiguous()
    assert table.dtype == torch.float32
    for q, name in enumerate(sk.SAMPLE_NAMES):
        assert torch.equal(table[0, ..., q], grid.prim[grid.ind[name], 0])
    assert coords.shape == (3 + 2 * (n_i + n_j + n_k),)
    assert torch.equal(coords[:n_i + 1], grid.x1f[0])


def test_run_matches_jax_run(tmp_path):
    text = _config_text(tmp_path / "jax.npz", output_camera="true")
    ref = jax_pipeline.run(jax_parse_config(text), quiet=True)
    cfg = parse_config(_config_text(tmp_path / "torch.npz",
                                    output_camera="true"))
    ours = pipeline.run(cfg, quiet=True, device="cpu")
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


def test_render_simulation_image_matches_jax(tmp_path):
    overrides = dict(camera_resolution=8, ray_integrator="rk2")
    cfg = _config(tmp_path, **overrides)
    ref, _, jfreqs, jmass = jax_sim.render_simulation_image(
        _jax_config(tmp_path, **overrides))
    image, rays, freqs, mass = pipeline_simulation.render_simulation_image(
        cfg, device="cpu")
    assert mass == jmass
    np.testing.assert_array_equal(freqs.numpy(), np.asarray(jfreqs))
    np.testing.assert_array_equal(image["_n_samples"].numpy(),
                                  np.asarray(ref["_n_samples"]))
    np.testing.assert_allclose(image["I_nu"].numpy(),
                               np.asarray(ref["I_nu"]).reshape(64, 1),
                               rtol=1e-8)


def test_cli_reports_reading_time(tmp_path, capsys):
    inp = tmp_path / "sim.input"
    inp.write_text(_config_text(tmp_path / "cli.npz", res=4,
                                ray_max_steps=40))
    assert cli.main(["--device", "cpu", str(inp)]) == 0
    out = capsys.readouterr().out
    assert "Calculation completed." in out
    reading = float(re.search(r"Time reading simulation data:\s+(\S+) s",
                              out).group(1))
    assert reading > 0.0
    assert np.load(tmp_path / "cli.npz")["I_nu"].shape == (4, 4)


def test_grid_argument_skips_loading(tmp_path):
    """make_simulation_renderer(grid=...) renders a snapshot built in
    memory, through the function load_athdf ends in."""
    cfg = _config(tmp_path, camera_resolution=4, ray_max_steps=40,
                  simulation_file=tmp_path / "missing.athdf")
    loaded = pipeline_simulation.load_grid(
        _config(tmp_path), device="cpu", dtype=torch.float64)
    render_fn, geom, rays, freqs, _ = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cpu",
                                                     grid=loaded)
    assert render_fn.kernel_args[3] is loaded
    image = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    assert image["I_nu"].shape == (16, 1)
    with pytest.raises(OSError):
        pipeline_simulation.make_simulation_renderer(cfg, device="cpu")


# Simulation configurations the port refuses, each with what its error
# must say: the ROADMAP item of a configuration outside the port's slice,
# or the JAX package's errors: code_kappa without its slot's variable, and
# the coordinate errors (harm3d snapshots are read in SKS
# only, grid/harm3d.py; an Athena++ file is SKS, not CKS, which is
# AthenaK's)
OUT_OF_SLICE = {
    "harm3d": ({"simulation_format": "harm3d", "simulation_coord": "cks"},
               "Invalid simulation_coord for Harm format."),
    "cks": ({"simulation_coord": "cks"},
            "simulation_coord does not match the loaded grid's "
            "coordinates."),
    "slow_light": ({"simulation_multiple": "true", "slow_light_on": "true",
                    "slow_chunk_size": 2, "slow_t_start": 0.0,
                    "slow_dt": 1.0, "slow_interp": "false",
                    "slow_num_images": 1, "slow_offset": 0,
                    "simulation_start": 0, "simulation_end": 1},
                   "ROADMAP B.6)"),
    # code_kappa without the kappa slot's variable: the JAX package's
    # error (blacklight_tpu/pipeline_simulation.py:118-120)
    "code_kappa": ({"plasma_model": "code_kappa"},
                   "Must specify simulation_kappa_name in input file for "
                   "this configuration."),
    # adaptive configurations the JAX package refuses, with its errors
    # (blacklight_tpu/adaptive.py:56-58, output.py:45-46)
    "adaptive_block_size": ({"adaptive_max_level": 1,
                             "adaptive_block_size": 5,
                             "adaptive_num_regions": 0},
                            "adaptive_block_size must divide "
                            "camera_resolution."),
    "adaptive_npy": ({"adaptive_max_level": 1, "adaptive_block_size": 4,
                      "adaptive_num_regions": 0, "output_format": "npy"},
                     "Only npz outputs support adaptive ray tracing."),
}


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_out_of_slice_simulation_config_raises(tmp_path, case):
    overrides, message = OUT_OF_SLICE[case]
    cfg = _config(tmp_path, **overrides)
    with pytest.raises(BlacklightError, match=re.escape(message)):
        pipeline.run(cfg, quiet=True, device="cpu")
    assert not (tmp_path / "out.npz").exists()


