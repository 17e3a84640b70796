"""PyTorch port: the polarized (full-Stokes IQUV) simulation path against
the JAX package.

The plain renderer (ops/polarized_kernel.render_polarized_reference and
the camera-frame Stokes extraction) runs on the JAX package's own camera
rays and is held to the JAX XLA path: golden_polarized_rk4_32.input on
mock_small.athdf at 16^2 with 400 steps of 0.04 (at the fixture's 0.01
step and a few hundred steps every ray hits ray_max_steps, and
fallback_nan turns every pixel NaN). Then pipeline.run on the CPU
against the JAX run in npz and npy, and the slice guard.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import pipeline_simulation as jax_sim
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import (BlacklightError, interop, parse_config,
                                  pipeline, pipeline_simulation, read_config)
from blacklight_tpu_torch.ops import polarized_kernel as pk

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CSRC = pathlib.Path(pk.__file__).resolve().parent.parent / "csrc"
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")


def _config_text(out, res=16, name="golden_polarized_rk4_32.input",
                 **overrides):
    """``name`` on mock_small.athdf at ``res``^2 with 400 steps of 0.04,
    and ``overrides`` (key = value, as in an input file)."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": out, "camera_resolution": res,
                "ray_step": 0.04, "ray_max_steps": 400, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


# name -> (input overrides, gate)
CASES = {
    "rk4_float64": ({}, "exact"),
    "dp_float64": ({"ray_integrator": "dp"}, "statistical"),
    "rk2_float32_split_two_frequencies": (
        {"ray_integrator": "rk2", "precision": "float32",
         "image_rotation_split": "true", "image_num_frequencies": 2,
         "image_frequency_start": 1.5e11, "image_frequency_end": 4.6e11,
         "image_frequency_spacing": "log"}, "statistical"),
}

# Per-channel rtol of the exact case, with the floor of
# tests/test_polarized_e2e.py:40. V is amplified most: a relative change of
# 1e-15 in the camera rays moves the plain version's own V by 1.1e-8 at
# 8^2, and the two frameworks round their transcendentals differently.
EXACT_RTOL = {"I_nu": 1e-8, "Q_nu": 1e-8, "U_nu": 1e-8, "V_nu": 1e-5}


@pytest.fixture(scope="module", params=sorted(CASES))
def renders(request, tmp_path_factory):
    """(gate, ours, ref): the plain renderer and the JAX XLA path on the
    JAX package's camera rays, as numpy dicts with STOKES (B, F),
    _flags and _n_samples."""
    overrides, gate = CASES[request.param]
    out = tmp_path_factory.mktemp("pol") / "out.npz"
    jrender, _, rays, _, _ = jax_sim.make_simulation_renderer(
        jax_parse_config(_config_text(out, **overrides)))
    ref = jrender(rays.positions, rays.directions, rays.momentum_factors)
    cfg = parse_config(_config_text(out, **overrides))
    precision = cfg.precision or "float64"
    render_fn, *_ = pipeline_simulation.make_simulation_renderer(
        cfg, device="cpu")
    t = interop.camera_rays_from_numpy(
        rays.positions, rays.directions, rays.momentum_factors,
        device="cpu", dtype=TORCH_DTYPE[precision])
    before = pk.LAUNCHES
    ours = render_fn(t.positions, t.directions, t.momentum_factors)
    assert pk.LAUNCHES == before  # the CPU runs the plain version
    assert ours["I_nu"].dtype == TORCH_DTYPE[precision]
    n = t.positions.shape[0]
    ours = {k: v.numpy() for k, v in ours.items()}
    ref = {k: np.asarray(v).reshape(n, -1) if k in STOKES else np.asarray(v)
           for k, v in ref.items()}
    return gate, ours, ref


def test_plain_matches_jax_xla_path(renders):
    gate, ours, ref = renders
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    assert i_scale > 0.0 and np.isfinite(ref["I_nu"]).mean() > 0.5
    for k in STOKES:
        assert ours[k].shape == ref[k].shape, k
        assert np.array_equal(np.isnan(ours[k]), np.isnan(ref[k])), k
        assert np.nanmax(np.abs(ref[k])) > 0.0, k
    if gate == "exact":
        assert np.array_equal(ours["_flags"], ref["_flags"])
        assert np.array_equal(ours["_n_samples"], ref["_n_samples"])
        for k in STOKES:
            floor = max(np.nanmax(np.abs(ref[k])) * 1e-4, i_scale * 1e-8)
            rel = np.abs(ours[k] - ref[k]) / (np.abs(ref[k]) + floor)
            assert np.nanmax(rel) < EXACT_RTOL[k], (k, np.nanmax(rel))
        return
    # statistical: every channel as a fraction of I's peak (the chip's gate
    # for Q/U/V of the kernel against the plain version) and I's total
    # flux. Pixel by pixel the two frameworks part further: the Faraday
    # rotation amplifies rounding, and in float32 7.4 % of the rk2 case's
    # I pixels differ by more than 1e-3 relative (measured, 16^2).
    for f in range(ref["I_nu"].shape[1]):
        a, b = ours["I_nu"][:, f], ref["I_nu"][:, f]
        assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))
    for k in STOKES:
        frac = np.abs(ours[k] - ref[k]) / i_scale
        assert np.nanpercentile(frac, 99.5) < 1e-3, (k, frac)
        assert np.nanmax(frac) < 1e-2, (k, np.nanmax(frac))


def test_kernel_param_order_matches_header():
    """PARAM_NAMES is csrc/simulation_params.cuh's enum, then
    csrc/polarized_params.cuh's, in order."""
    enums = []
    for name, enum_name in (("simulation_params.cuh", "SimulationParam"),
                            ("polarized_params.cuh", "PolarizedParam")):
        header = (CSRC / name).read_text()
        body = re.search(rf"enum {enum_name} : int \{{(.*?)\}};", header,
                         re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        enums += [n.split("=")[0].strip()[2:] for n in body.split(",")
                  if n.strip()]
    assert enums.count("COUNT") == 2
    names = [n for n in enums if n != "COUNT"]
    assert tuple(names) == pk.PARAM_NAMES


def test_kernel_params(tmp_path):
    cfg = parse_config(_config_text(tmp_path / "o.npz",
                                    image_rotation_split="true",
                                    fallback_rho=1e-4))
    render_fn, geom, rays, freqs, mass = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cpu")
    assert render_fn.kernel is pk.render_polarized
    assert render_fn.kernel_kwargs == {"integrator": "rk4",
                                       "rotation_split": True}
    _, params, sp, grid, mass_msun, camera_x, _ = render_fn.kernel_args
    values = dict(zip(pk.PARAM_NAMES, pk.kernel_params(
        params, sp, float(freqs[0]), mass_msun, camera_x, True)))
    assert values["ROTATION_SPLIT"] == 1.0
    assert values["FALLBACK_RHO"] == 1e-4 and values["FALLBACK_PGAS"] == 0.0
    assert values["MAX_STEPS"] == 400.0
    # the route's buffers: 400 sample slots of 7 values a ray; a record
    # slot of 32 rays holds 50 values and 8 per frequency
    assert pk.sample_bytes_per_ray(torch.float32, 400) == 400 * 7 * 4
    assert pk.sample_bytes_per_ray(torch.float64, 400) == 400 * 7 * 8
    assert pk.record_bytes_per_slot(torch.float32, 1) == 32 * (50 + 8) * 4
    assert pk.record_bytes_per_slot(torch.float64, 2) == 32 * (50 + 16) * 8


def test_other_device_raises(tmp_path):
    """Rays on a device that is neither the CPU nor a card are refused:
    render_polarized never falls back to the plain version."""
    cfg = parse_config(_config_text(tmp_path / "o.npz", camera_resolution=2))
    render_fn, _, rays, _, _ = pipeline_simulation.make_simulation_renderer(
        cfg, device="cpu")
    meta = [t.to("meta") for t in (rays.positions, rays.directions,
                                   rays.momentum_factors)]
    with pytest.raises((TypeError, ValueError)):
        pk.render_polarized(*meta, *render_fn.kernel_args,
                            **render_fn.kernel_kwargs)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("pol_run")
    text = _config_text(d / "jax.npz", res=8, output_camera="true")
    arrays = jax_pipeline.run(jax_parse_config(text), quiet=True)
    return arrays, np.load(d / "jax.npz")


def _assert_close(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, key
    if a.dtype.kind != "f":
        assert np.array_equal(a, b), key
        return
    assert np.array_equal(np.isnan(a), np.isnan(b)), key
    if key not in STOKES:
        # entries that are zero up to rounding (the camera's t = 0)
        np.testing.assert_allclose(a, b, rtol=1e-8,
                                   atol=1e-14 * np.nanmax(np.abs(b)),
                                   err_msg=key)
        return
    floor = np.nanmax(np.abs(b)) * 1e-4
    rel = np.abs(a - b) / (np.abs(b) + floor)
    assert np.nanmax(rel) < EXACT_RTOL[key], (key, np.nanmax(rel))


def test_run_matches_jax_run_npz(jax_run, tmp_path):
    ref_arrays, ref_file = jax_run
    cfg = read_config_text(tmp_path, "torch.npz", output_camera="true")
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    assert set(arrays) == set(ref_arrays) >= set(STOKES)
    for key in ref_arrays:
        _assert_close(arrays[key], ref_arrays[key], key)
    written = np.load(tmp_path / "torch.npz")
    assert set(written.keys()) == set(ref_file.keys())
    for key in ref_file.keys():
        _assert_close(written[key], ref_file[key], key)


def test_run_matches_jax_run_npy(jax_run, tmp_path):
    """npy holds the packed (4, res, res) I, Q, U, V block, as the JAX
    run packs it."""
    ref_arrays, _ = jax_run
    cfg = read_config_text(tmp_path, "torch.npy", output_format="npy")
    pipeline.run(cfg, quiet=True, device="cpu")
    packed = np.load(tmp_path / "torch.npy")
    assert packed.shape == (4, 8, 8)
    for i, key in enumerate(STOKES):
        _assert_close(packed[i], ref_arrays[key], key)


def read_config_text(tmp_path, out, **overrides):
    path = tmp_path / "in.input"
    path.write_text(_config_text(tmp_path / out, res=8, **overrides))
    return read_config(str(path))


OUT_OF_SLICE = {
    "checkpoint": ({"checkpoint_sample_save": "true",
                    "checkpoint_sample_file": "s.npz"},
                   "golden_polarized_rk4_32.input", "A.8"),
}


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_check_slice_refuses(tmp_path, case):
    overrides, name, item = OUT_OF_SLICE[case]
    cfg = parse_config(_config_text(tmp_path / "x.npz", name=name,
                                    **overrides))
    assert cfg.image_polarization
    with pytest.raises(BlacklightError, match=item):
        pipeline.check_slice(cfg)
    with pytest.raises(BlacklightError, match=item):
        pipeline.run(cfg, quiet=True, device="cpu")
    assert not (tmp_path / "x.npz").exists()
