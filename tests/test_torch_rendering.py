"""PyTorch port: false-color rendering (ROADMAP D.1) and the scan route's
compacted loop (ROADMAP R5).

``transfer/rendering.integrate_rendering`` against the JAX package's
``integrate_rendering`` on the same rays and the same cell values, and
``pipeline.run``'s npz "rendering" against the JAX package's ``run``, on
mock_small.athdf at 16^2, 300 steps of 0.03 (rk4 and rk2 in float64 at
rtol 1e-8 with an
absolute floor of 1e-10 of the peak, tests/test_render_truecolor.py:16-24;
dp at that file's statistical gate, :27-34): fill features inside and
outside their bounds with dtau on both sides of DELTA_TAU_MAX, thresh,
rise and fall, two images, NaN cells, the polarized route, an adaptive
level. Then the scan route's loop (``ops/geodesic.trace_compacted``,
which drops finished rays) against the lock-step loop over the whole
bundle (``trace_reference`` with the same per-sample update), every
output bit for bit, for dp, rk4 and rk2; and the formula model's
"Ignoring request for rendering."
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import pipeline_simulation as jax_sim
from blacklight_tpu.transfer import rendering as jax_rendering
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import interop, parse_config, pipeline
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.ops import geodesic
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk
from blacklight_tpu_torch.transfer import rendering

from test_torch_adaptive import POL_RTOL
from test_torch_adaptive import _sim_text as _adaptive_text
from test_torch_aux_planes import ALL_PLANES, FORMULA_PLANES, _formula_text

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

# render_* lines by case: (features of each image), each feature a dict;
# None: golden_render_rk4_32.input's own (fill rho, fill sigma, thresh
# beta_inverse)
FEATURES = {
    "golden": None,
    # rho's fill only within [1e-17, 3e-16], sigma's above 0.5; tau_scale
    # of 3e9 cm puts a 16^2 render's steps on both sides of DELTA_TAU_MAX
    "fill_bounds_tau_sides": ((
        dict(quantity="rho", type="fill", min=1e-17, max=3e-16,
             tau_scale=3e9, rgb="106,121,247"),
        dict(quantity="sigma", type="fill", min=0.5, max="inf",
             tau_scale=1e13, rgb="214,76.5,66.7")),),
    # rise and fall on two images, their features interleaved with fills
    "rise_fall_two_images": (
        (dict(quantity="beta_inverse", type="rise", thresh=0.1,
              opacity=0.3, xyz="0.12,0.246,0.089"),
         dict(quantity="rho", type="fill", min=1e-18, max="inf",
              tau_scale=1e13, rgb="10,200,30")),
        (dict(quantity="Theta_e", type="fall", thresh=5.0, opacity=0.6,
              xyz="0.5,0.2,0.9"),
         dict(quantity="sigma", type="thresh", thresh=0.3, opacity=0.25,
              rgb="255,128,0"))),
}
# cuts that NaN the cell values of part of the samples
NAN_CUTS = {"cut_rho_min": 3e-17, "cut_omit_in": 5.0}


def _render_lines(images) -> dict:
    lines = {"render_num_images": len(images)}
    for i, features in enumerate(images, 1):
        lines[f"render_{i}_num_features"] = len(features)
        for j, feat in enumerate(features, 1):
            for key, value in feat.items():
                lines[f"render_{i}_{j}_{key}"] = value
    return lines


def _text(out, case="golden", name="golden_render_rk4_32.input", res=16,
          steps=300, step=0.03, **overrides):
    """``name`` on mock_small.athdf at ``res``^2 with ``steps`` steps of
    ``step``, the renderings of FEATURES[case], and ``overrides``."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": FIXTURES / "mock_small.athdf",
                "output_file": out, "camera_resolution": res,
                "ray_step": step, "ray_max_steps": steps, **overrides}
    if FEATURES[case] is not None:
        text = re.sub(r"^render_.*$", "", text, flags=re.M)
        settings.update(_render_lines(FEATURES[case]))
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _assert_rendering(ours, ref, gate):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    peak = np.abs(ref).max()
    assert peak > 0.0
    if gate == "exact":
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=peak * 1e-10)
    else:
        err = np.abs(ours - ref) / peak
        assert np.nanmean(err) < 5e-3
        assert np.nanmax(err) < 2e-1


class _Seen:
    """What the port's renderer met over a trace: the least and greatest
    dtau of a fill feature's valid samples, and whether a valid sample's
    cell values held NaN."""

    def __init__(self, monkeypatch, tau_scale=None):
        self.dtau, self.nan_cells = [], False
        delta_length, update = rendering.Renderer.delta_length, \
            rendering.Renderer.update

        def seen_length(renderer, valid, pos, kcov, h):
            out = delta_length(renderer, valid, pos, kcov, h)
            if tau_scale is not None and bool(valid.any()):
                self.dtau.append(out[valid] / tau_scale)
            return out

        def seen_update(renderer, st, valid, cells, length):
            self.nan_cells |= bool(torch.isnan(cells[valid]).any())
            return update(renderer, st, valid, cells, length)

        monkeypatch.setattr(rendering.Renderer, "delta_length", seen_length)
        monkeypatch.setattr(rendering.Renderer, "update", seen_update)


# name -> (FEATURES case, overrides, gate)
INTEGRATE_CASES = {
    "golden_rk4": ("golden", {}, "exact"),
    "fill_bounds_tau_sides": ("fill_bounds_tau_sides", {}, "exact"),
    "rise_fall_two_images_nan_cells": ("rise_fall_two_images", NAN_CUTS,
                                       "exact"),
    "golden_dp": ("golden", {"ray_integrator": "dp"}, "statistical"),
}


@pytest.mark.parametrize("case", sorted(INTEGRATE_CASES))
def test_integrate_rendering_matches_jax(tmp_path, monkeypatch, case):
    """integrate_rendering on the JAX package's camera rays, each
    package with its own cell_fn, float64."""
    features, overrides, gate = INTEGRATE_CASES[case]
    text = _text(tmp_path / "r.npz", features, **overrides)
    jcfg, cfg = jax_parse_config(text), parse_config(text)
    jrender, jgeom, rays, jfreqs, mass_msun = \
        jax_sim.make_simulation_renderer(jcfg)
    jgrid, _ = jax_sim.load_grid(jcfg)
    _, jcell_fn, _ = jax_sim.make_simulation_coeff_fns(
        jcfg, jgrid, jgeom, jfreqs, rays.momentum_factors, polarized=False)
    ref, ref_flags, ref_n = jax_rendering.integrate_rendering(
        rays.positions, rays.directions, jrender.geodesic_params, jcell_fn,
        tuple(jcfg.render_images), mass_msun)

    render_fn, geom, _, freqs, port_mass = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cpu")
    assert render_fn.route == "scan"
    _, params, sp, grid, _, camera_x, _ = render_fn.kernel_args
    t = interop.camera_rays_from_numpy(
        rays.positions, rays.directions, rays.momentum_factors,
        device="cpu", dtype=torch.float64)
    _, cell_fn = pipeline_simulation.make_simulation_coeff_fns(
        sp, grid, freqs, t.momentum_factors, params.bh_a, camera_x,
        polarized=False)
    tau_scale = None
    if case == "fill_bounds_tau_sides":
        tau_scale = FEATURES[case][0][0]["tau_scale"]
    seen = _Seen(monkeypatch, tau_scale)
    ours, flags, n_samples = rendering.integrate_rendering(
        t.positions, t.directions, params, cell_fn, cfg.render_images,
        port_mass, camera_x)
    assert ours.shape == (256, len(cfg.render_images), 3)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(ref_flags))
    if gate == "exact":
        np.testing.assert_array_equal(n_samples.numpy(), np.asarray(ref_n))
    _assert_rendering(ours.numpy(), ref, gate)
    if tau_scale is not None:
        dtau = torch.cat(seen.dtau)
        assert (dtau > rendering.DELTA_TAU_MAX).any()
        assert (dtau <= rendering.DELTA_TAU_MAX).any()
    if case.endswith("nan_cells"):
        assert seen.nan_cells


# name -> (FEATURES case, overrides, gate, the run's planes besides it)
RUN_CASES = {
    "rk4_with_tau": ("golden", {"image_light": "true", "image_tau": "true"},
                     "exact", ("I_nu", "tau")),
    "dp": ("golden", {"ray_integrator": "dp"}, "statistical", ()),
    "polarized": ("rise_fall_two_images",
                  {"image_light": "true", "image_polarization": "true",
                   "image_rotation_split": "false",
                   "camera_resolution": 8, "ray_step": 0.06,
                   "ray_max_steps": 200},
                  "exact", ("I_nu",)),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_rendering_matches_jax(tmp_path, case):
    """pipeline.run's npz against the JAX package's run: "rendering"
    (n_images, 3, res, res) at the case's gate, and the image planes of the
    same trace (rk4, rtol 1e-8) or Stokes I of the polarized route (over a
    floor of 1e-4 of its peak at test_torch_adaptive.POL_RTOL, as the
    repository's polarized runs are held; in this flat-spacetime
    configuration Q parts from the JAX package's by 2.1e-7, ROADMAP §3
    F3)."""
    features, overrides, gate, planes = RUN_CASES[case]
    text = _text(tmp_path / "torch.npz", features, **overrides)
    launches = sk.LAUNCHES, pk.LAUNCHES
    ours = pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert (sk.LAUNCHES, pk.LAUNCHES) == launches
    ref = jax_pipeline.run(jax_parse_config(
        text.replace(str(tmp_path / "torch.npz"), str(tmp_path / "j.npz"))),
        quiet=True)
    res = int(overrides.get("camera_resolution", 16))
    n_images = len(FEATURES[features] or ((),))
    assert ours["rendering"].shape == (n_images, 3, res, res)
    written = np.load(tmp_path / "torch.npz")["rendering"]
    np.testing.assert_array_equal(written, ours["rendering"])
    _assert_rendering(ours["rendering"], ref["rendering"], gate)
    for key in planes:
        a, b = ours[key], ref[key]
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        floor = np.nanmax(np.abs(b)) * (1e-4 if key in POL_RTOL else 1e-14)
        rel = np.abs(a - b) / (np.abs(b) + floor)
        assert np.nanmax(rel) < POL_RTOL.get(key, 1e-8), key


def test_adaptive_level_rendering_matches_jax(tmp_path):
    """One adaptive level (a 12^2 root, blocks of 3 by golden_adaptive_32's
    Laplacian criterion) with golden_render_rk4_32's renderings beside the
    light image: the root's and the level's rendering against the JAX
    package's run."""
    text = _adaptive_text(
        tmp_path / "torch.npz", simulation_file=FIXTURES / "mock_small.athdf",
        adaptive_max_level=1, camera_resolution=12, adaptive_block_size=3)
    golden = (FIXTURES / "golden_render_rk4_32.input").read_text()
    text = re.sub(r"^render_num_images.*$", "", text, flags=re.M) + "".join(
        line + "\n" for line in golden.splitlines()
        if line.startswith("render_"))
    ours = pipeline.run(parse_config(text), quiet=True, device="cpu")
    ref = jax_pipeline.run(jax_parse_config(
        text.replace(str(tmp_path / "torch.npz"), str(tmp_path / "j.npz"))),
        quiet=True)
    n_blocks = ours["adaptive_num_blocks"]
    assert len(n_blocks) == 2 and 0 < n_blocks[1] < 4 * n_blocks[0]
    assert ours["adaptive_rendering_1"].shape == (1, 3, n_blocks[1], 3, 3)
    assert set(ours) == set(ref)
    for key in ("rendering", "adaptive_rendering_1"):
        _assert_rendering(ours[key], ref[key], "exact")
    np.testing.assert_allclose(ours["adaptive_I_nu_1"],
                               ref["adaptive_I_nu_1"], rtol=1e-8,
                               atol=1e-14 * np.abs(ref["adaptive_I_nu_1"]).max())


# ---- the compacted loop (R5) ---------------------------------------------

def _whole_bundle(positions, directions, params, integrator, carry,
                  on_sample):
    """trace_compacted's contract on the lock-step loop over the whole
    bundle: the per-step loop the scan route ran before it dropped
    finished rays."""
    flag, n_samples = geodesic.trace_reference(
        positions, directions, params, integrator,
        lambda *sample: on_sample(*sample, carry))
    return flag, n_samples, carry


# integrator -> overrides: every plane, two renderings, 15^2 rays (the
# last 33 are the fixed rows of a compacted bundle)
COMPACT_CASES = {
    "rk4": {},
    "rk2": {"fallback_nan": "false", **NAN_CUTS},
    "dp": {"precision": "float32"},
}


@pytest.mark.parametrize("integrator", sorted(COMPACT_CASES))
def test_compacted_route_bit_for_bit(tmp_path, monkeypatch, integrator):
    """The scan route with every plane and two renderings, its loop
    dropping finished rays (some compactions happen), against the same
    route on the lock-step loop over the whole bundle: every output equal
    bit for bit."""
    text = _text(tmp_path / "c.npz", "rise_fall_two_images", res=15,
                 ray_integrator=integrator, image_light="true", **ALL_PLANES,
                 **COMPACT_CASES[integrator])
    render_fn, _, rays, _, _ = pipeline_simulation.make_simulation_renderer(
        parse_config(text), device="cpu")
    assert render_fn.route == "scan"
    gathers = []
    gather = geodesic._gather_state
    monkeypatch.setattr(geodesic, "_gather_state",
                        lambda state, index: gathers.append(
                            index.shape[0]) or gather(state, index))
    ours = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    assert gathers and gathers[-1] < 225 and all(
        (n - 225 % geodesic.COMPACT_ROWS) % geodesic.COMPACT_ROWS == 0
        for n in gathers), gathers
    monkeypatch.setattr(geodesic, "trace_compacted", _whole_bundle)
    ref = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype, key
        assert torch.equal(ours[key].isnan(), value.isnan()), key
        assert torch.equal(torch.nan_to_num(ours[key], nan=0.0),
                           torch.nan_to_num(value, nan=0.0)), key


def test_compacted_formula_route_bit_for_bit(tmp_path, monkeypatch):
    """The formula model's scan route (dp, every plane it has): the
    compacted loop against the whole bundle, bit for bit."""
    text = _formula_text(tmp_path / "f.npz", res=12, ray_integrator="dp",
                         ray_tol_abs=1e-8, ray_tol_rel=1e-8,
                         ray_max_retries=20, **FORMULA_PLANES)
    render_fn, _, rays, _, _ = pipeline.make_formula_renderer(
        parse_config(text), device="cpu")
    assert render_fn.route == "scan"
    ours = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    monkeypatch.setattr(geodesic, "trace_compacted", _whole_bundle)
    ref = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert torch.equal(torch.nan_to_num(ours[key], nan=-1.0),
                           torch.nan_to_num(value, nan=-1.0)), key


def test_formula_ignores_rendering(tmp_path, capsys):
    """A formula input with render_num_images = 1 renders its image with
    the JAX package's warning, and no rendering (as the JAX package's
    run)."""
    text = _formula_text(tmp_path / "f.npz", res=8) \
        + "render_num_images = 1\n"
    ours = pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert "Ignoring request for rendering." in capsys.readouterr().err
    ref = jax_pipeline.run(jax_parse_config(
        text.replace(str(tmp_path / "f.npz"), str(tmp_path / "j.npz"))),
        quiet=True)
    assert "rendering" not in ours and set(ours) == set(ref)
    np.testing.assert_allclose(ours["I_nu"], ref["I_nu"], rtol=1e-7)
