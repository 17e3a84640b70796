"""PyTorch port: renders of multi-block and AMR Athena++ snapshots and of
nearest-cell sampling through ``pipeline.run(device="cpu")`` (the kernels'
plain versions) against the JAX package's ``render_simulation_image``.

The configurations are golden_sim_rk4_32.input / golden_amr_rk4_32.input
/ golden_polarized_rk4_32.input at 16^2 (8^2 polarized) with at most 300
steps, rk4 in float64: I_nu at rtol 1e-8 with identical NaN sets (the
polarized V at rtol 1e-5, as tests/test_torch_polarized_pipeline.py
holds it). Grids: 4-block phi splits written by write_athena(...,
phi_blocks=4) of fields without and with phi structure (pert_amp 0 and
0.1), mock_amr.athdf (two refinement levels) and mock_small.athdf.
"""

import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline_simulation as jax_sim
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import BlacklightError, parse_config, pipeline
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.grid.athena import simulation_grid
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
import generate_mock_simulation as gen  # noqa: E402

STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
RTOL = {"I_nu": 1e-8, "Q_nu": 1e-8, "U_nu": 1e-8, "V_nu": 1e-5}

# name -> (input file, snapshot, overrides)
CASES = {
    "four_blocks": ("golden_sim_rk4_32.input", "four", {}),
    "four_blocks_interblock": ("golden_sim_rk4_32.input", "four",
                               {"simulation_block_interp": "true"}),
    "four_blocks_phi_structure": ("golden_sim_rk4_32.input", "four_pert",
                                  {}),
    "four_blocks_phi_structure_interblock": (
        "golden_sim_rk4_32.input", "four_pert",
        {"simulation_block_interp": "true"}),
    "amr_interblock": ("golden_amr_rk4_32.input", "amr", {}),
    "amr_trilinear": ("golden_amr_rk4_32.input", "amr",
                      {"simulation_block_interp": "false",
                       "ray_integrator": "rk2"}),
    "nearest": ("golden_sim_rk4_32.input", "single",
                {"simulation_interp": "false"}),
    "amr_nearest_three_frequencies": (
        "golden_amr_rk4_32.input", "amr",
        {"simulation_interp": "false", "image_num_frequencies": 3,
         "image_frequency_start": 1e11, "image_frequency_end": 6e11,
         "image_frequency_spacing": "log"}),
    "amr_interblock_polarized": (
        "golden_polarized_rk4_32.input", "amr",
        {"simulation_block_interp": "true", "camera_resolution": 8,
         "ray_step": 0.04, "ray_max_steps": 300}),
}


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_blocks_pipeline")
    # mock_small.athdf's grid and radii
    p = dict(gen.DEFAULTS, n_r=64, n_th=32, n_ph=32, r_min=1.916,
             r_max=52.2)
    gen.write_athena(str(tmp / "four.athdf"), gen.make_fields(p), p,
                     phi_blocks=4)
    # the same with fields that vary in phi, so that interblock sampling
    # across the phi faces (and the phi seam) changes the image
    p = dict(p, pert_amp=0.1)
    gen.write_athena(str(tmp / "four_pert.athdf"), gen.make_fields(p), p,
                     phi_blocks=4)
    return {"four": tmp / "four.athdf", "four_pert": tmp / "four_pert.athdf",
            "amr": FIXTURES / "mock_amr.athdf",
            "single": FIXTURES / "mock_small.athdf"}


def _config_text(name, snapshot, out, **overrides):
    """``name`` on ``snapshot`` at 16^2 with 300 steps of 0.03, and
    ``overrides`` (key = value, as in an input file)."""
    text = (FIXTURES / name).read_text()
    settings = {"simulation_file": snapshot, "output_file": out,
                "camera_resolution": 16, "ray_step": 0.03,
                "ray_max_steps": 300, **overrides}
    for key, value in settings.items():
        line = f"{key} = {value}"
        text, n = re.subn(rf"^{key}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _render_both(snapshots, tmp_path, case):
    name, snap, overrides = CASES[case]
    text = _config_text(name, snapshots[snap], tmp_path / "out.npz",
                        **overrides)
    ref, *_ = jax_sim.render_simulation_image(jax_parse_config(text))
    cfg = parse_config(text)
    launches = (sk.LAUNCHES, sk.PHASE_LAUNCHES, pk.LAUNCHES)
    ours = pipeline.run(cfg, quiet=True, device="cpu")
    assert (sk.LAUNCHES, sk.PHASE_LAUNCHES, pk.LAUNCHES) == launches
    return cfg, ours, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_matches_jax(snapshots, tmp_path, case):
    cfg, ours, ref = _render_both(snapshots, tmp_path, case)
    res = cfg.camera_resolution
    keys = STOKES if cfg.image_polarization else ("I_nu",)
    i_scale = np.nanmax(np.abs(np.asarray(ref["I_nu"])))
    assert i_scale > 0.0
    for key in keys:
        # ours (F, res, res) or (res, res); the JAX image (B, F)
        a = np.asarray(ours[key]).reshape(-1, res * res).T
        b = np.asarray(ref[key]).reshape(res * res, -1)
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        assert np.isfinite(b).mean() > 0.5, key
        floor = max(np.nanmax(np.abs(b)) * 1e-4, i_scale * 1e-8) \
            if key != "I_nu" else 0.0
        rel = np.abs(a - b) / (np.abs(b) + floor)
        assert np.nanmax(rel) < RTOL[key], (key, np.nanmax(rel))


def test_phased_run_matches_jax(snapshots, tmp_path, monkeypatch):
    """Phased dispatch (the plain phase version, phases of 100 steps) on
    mock_amr with interblock sampling."""
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASED", True)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_STEPS", 100)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_CHUNK", 1)
    assert pipeline_simulation.use_phased("rk4", 300, 256)
    cfg, ours, ref = _render_both(snapshots, tmp_path, "amr_interblock")
    a = np.asarray(ours["I_nu"]).reshape(-1)
    b = np.asarray(ref["I_nu"]).reshape(-1)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=0.0)


def test_block_interp_without_metadata_raises(snapshots, tmp_path):
    """A multi-block snapshot built in memory without refinement
    metadata: interblock sampling is refused before any ray is traced
    (ROADMAP B.5b)."""
    name, snap, overrides = CASES["four_blocks_interblock"]
    cfg = parse_config(_config_text(name, snapshots[snap],
                                    tmp_path / "out.npz", **overrides))
    g = pipeline_simulation.load_grid(cfg, device="cpu", dtype=torch.float64)
    bare = simulation_grid(g.prim, g.x1f, g.x1v, g.x2f, g.x2v, g.x3f, g.x3v,
                           g.ind, g.time, device="cpu", dtype=torch.float64)
    with pytest.raises(BlacklightError, match=re.escape("ROADMAP B.5b")):
        pipeline.run(cfg, quiet=True, device="cpu", grid=bare)
    assert not (tmp_path / "out.npz").exists()
