"""PyTorch port: the auxiliary image planes (ROADMAP A.5), simulation
model, unpolarized and polarized.

The scan route of ``pipeline_simulation.make_simulation_renderer``
(``transfer/unpolarized.integrate_unpolarized`` or
``transfer/polarized.integrate_polarized`` with
``make_simulation_coeff_fns``) against the JAX package's XLA path, which
its renderer takes on the CPU, on the JAX package's own camera rays:
the harness of test_torch_simulation_pipeline.py (mock_small.athdf, 16^2,
300 steps of 0.03); rk4 and rk2 in float64 exact, dp float64 at the
statistical gate, float32 at the float32 gate of test_torch_aux_planes.py;
``pipeline.run`` against the JAX ``run`` with every plane; the polarized
route at 8^2 with every plane.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import pipeline_simulation as jax_sim
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import interop, parse_config, pipeline
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

from test_torch_aux_planes import ALL_PLANES, assert_planes

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")


def _config_text(out, name="golden_sim_rk4_32.input", res=16, steps=300,
                 step=0.03, **overrides):
    """``name`` on mock_small.athdf at ``res``^2 with ``steps`` steps of
    ``step``, and ``overrides`` (key = value, as in an input file)."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": out, "camera_resolution": res,
                "ray_step": step, "ray_max_steps": steps, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _render_both(text, dtype, truth_text=None):
    """(ours, ref, route, truth): the port's renderer on the CPU and the
    JAX package's on the JAX package's camera rays, the port's route, and
    with ``truth_text`` the JAX package's render of that config on the
    same rays in float64."""
    jrender, _, rays, _, _ = jax_sim.make_simulation_renderer(
        jax_parse_config(text))
    ref = jrender(rays.positions, rays.directions, rays.momentum_factors)
    truth = None
    if truth_text is not None:
        jrender64, *_ = jax_sim.make_simulation_renderer(
            jax_parse_config(truth_text))
        truth = jrender64(*(np.asarray(a, np.float64) for a in (
            rays.positions, rays.directions, rays.momentum_factors)))
    render_fn, *_ = pipeline_simulation.make_simulation_renderer(
        parse_config(text), device="cpu")
    t = interop.camera_rays_from_numpy(
        rays.positions, rays.directions, rays.momentum_factors,
        device="cpu", dtype=dtype)
    launches = sk.LAUNCHES, pk.LAUNCHES, sk.PHASE_LAUNCHES
    ours = render_fn(t.positions, t.directions, t.momentum_factors)
    assert (sk.LAUNCHES, pk.LAUNCHES, sk.PHASE_LAUNCHES) == launches
    return ours, ref, render_fn.route, truth


# name -> (input overrides, gate)
CASES = {
    "rk4": (ALL_PLANES, "exact"),
    "rk2_cuts_no_fallback_nan": (
        dict(ALL_PLANES, ray_integrator="rk2", fallback_nan="false",
             cut_omit_near="true", cut_rho_min=1e-22, cut_theta_e_max=50.0,
             fallback_rho=1e-4), "exact"),
    "rk4_three_frequencies": (
        dict(ALL_PLANES, image_num_frequencies=3, image_frequency_start=1e11,
             image_frequency_end=6e11, image_frequency_spacing="log"),
        "exact"),
    "no_light": ({"image_light": "false", "image_tau": "true",
                  "image_lambda_ave": "true", "image_crossings": "true"},
                 "exact"),
    "dp": (dict(ALL_PLANES, ray_integrator="dp"), "statistical"),
    "rk4_float32": (dict(ALL_PLANES, precision="float32"), "float32"),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def renders(request, tmp_path_factory):
    overrides, gate = CASES[request.param]
    out = tmp_path_factory.mktemp("sim") / "o.npz"
    precision = "float32" if gate == "float32" else "float64"
    truth_text = _config_text(out, **dict(overrides, precision="float64")) \
        if gate == "float32" else None
    ours, ref, route, truth = _render_both(
        _config_text(out, **overrides), TORCH_DTYPE[precision], truth_text)
    return gate, ours, ref, truth, route


def test_scan_route_matches_jax_xla_path(renders):
    gate, ours, ref, truth, route = renders
    assert route == "scan"
    assert_planes(ours, ref, gate, truth)
    for key in ("I_nu", "tau", "lambda_ave", "tau_int"):
        if key in ref:
            assert np.nanmax(np.abs(np.asarray(ref[key]))) > 0.0, key
    if "lambda_ave" in ref:  # the cells of cut samples are left out
        assert np.isfinite(np.asarray(ref["lambda_ave"])).mean() > 0.5


def test_run_matches_jax_run_with_every_plane(tmp_path):
    text = _config_text(tmp_path / "jax.npz", output_camera="true",
                        **ALL_PLANES)
    ref = jax_pipeline.run(jax_parse_config(text), quiet=True)
    cfg = parse_config(text.replace(str(tmp_path / "jax.npz"),
                                    str(tmp_path / "torch.npz")))
    ours = pipeline.run(cfg, quiet=True, device="cpu")
    assert {"tau", "lambda_ave_rho", "emission_ave_sigma",
            "tau_int_beta_inverse", "crossings"} <= set(ref)
    for arrays in (ours, np.load(tmp_path / "torch.npz")):
        assert set(arrays.keys()) == set(ref.keys())
        for key in ref.keys():
            a, b = np.asarray(arrays[key]), np.asarray(ref[key])
            assert a.shape == b.shape and a.dtype == b.dtype, key
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            atol = 1e-14 * np.nanmax(np.abs(b)) if np.isfinite(b).any() \
                else 0.0
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=atol,
                                       err_msg=key)


# Stokes rtol of the exact polarized case with the floor of
# tests/test_polarized_e2e.py:40 (test_torch_polarized_pipeline.py)
POL_RTOL = {"I_nu": 1e-8, "Q_nu": 1e-8, "U_nu": 1e-8, "V_nu": 1e-5}


def test_polarized_scan_route_matches_jax(tmp_path):
    """golden_polarized_rk4_32.input at 8^2 (400 steps of 0.04) with every
    plane: I/Q/U at rtol 1e-8 and V at 1e-5 over the floor of
    tests/test_polarized_e2e.py:40, the planes at the tolerance of
    tests/test_polarized_e2e.py:86-105 (1e-8 of each plane's peak) with
    equal NaN sets, crossings equal."""
    text = _config_text(tmp_path / "p.npz", "golden_polarized_rk4_32.input",
                        res=8, steps=400, step=0.04, **ALL_PLANES)
    ours, ref, route, _ = _render_both(text, torch.float64)
    assert route == "scan"
    ours = {k: v.numpy() for k, v in ours.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert set(ours) == set(ref)
    assert np.array_equal(ours["_flags"], ref["_flags"])
    assert np.array_equal(ours["_n_samples"], ref["_n_samples"])
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    for key, value in ref.items():
        assert ours[key].shape == value.shape, key
        if key.startswith("_"):
            continue
        assert np.array_equal(np.isnan(ours[key]), np.isnan(value)), key
        if key == "crossings":
            assert np.array_equal(ours[key], value)
        elif key in STOKES:
            floor = max(np.nanmax(np.abs(value)) * 1e-4, i_scale * 1e-8)
            rel = np.abs(ours[key] - value) / (np.abs(value) + floor)
            assert np.nanmax(rel) < POL_RTOL[key], (key, np.nanmax(rel))
        else:
            scale = np.nanmax(np.abs(value)) or 1.0
            np.testing.assert_allclose(
                np.nan_to_num(ours[key]), np.nan_to_num(value),
                atol=1e-8 * scale, rtol=0.0, err_msg=key)
    assert np.nanmax(ref["tau"]) > 0.0 and np.nanmax(ref["crossings"]) > 0
