"""PyTorch port: the 32^2 formula, simulation and polarized goldens
through pipeline.run or the CLI on the CPU, at the tolerances of
test_formula_e2e.py, test_simulation_e2e.py and test_polarized_e2e.py
(reference-binary outputs), the auxiliary image planes' goldens among
them, the plasma models' (golden_code_kappa_32 among them), the adaptive
golden (golden_adaptive_32), the false-color renderings
(golden_render{,_rk4}_32), the true-color and pinhole goldens, and the
CLI's npz against the JAX package's."""

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import read_config as jax_read_config
from blacklight_tpu_torch import cli, pipeline, read_config

pytestmark = pytest.mark.slow

torch.set_num_threads(2)


def _render(fixtures_dir, tmp_path, name):
    cfg = read_config(str(fixtures_dir / f"{name}.input"))
    cfg.output_file = str(tmp_path / f"{name}.npz")
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    gold = np.load(fixtures_dir / f"{name}.npz")["I_nu"]
    return arrays["I_nu"], gold


@pytest.mark.parametrize("name", ["golden_formula_cam_rk4_32",
                                  "golden_formula_rk2_32"])
def test_rk_exact_parity(fixtures_dir, tmp_path, name):
    ours, gold = _render(fixtures_dir, tmp_path, name)
    np.testing.assert_allclose(ours, gold, rtol=1e-7)


def test_dp_quadrature_parity(fixtures_dir, tmp_path):
    ours, gold = _render(fixtures_dir, tmp_path, "golden_formula_32")
    rel = np.abs(ours - gold) / (np.abs(gold) + gold.max() * 1e-8)
    assert np.nanmax(rel) < 5e-3
    assert np.nanmean(rel) < 1e-3


def test_simulation_rk4_exact_parity(fixtures_dir, tmp_path):
    ours, gold = _render(fixtures_dir, tmp_path, "golden_sim_rk4_32")
    np.testing.assert_allclose(ours, gold, rtol=1e-8)


def test_amr_rk4_exact_parity(fixtures_dir, tmp_path):
    """golden_amr_rk4_32 on mock_amr.athdf (two refinement levels, exact
    interblock sampling): identical NaN sets, rtol 1e-8
    (tests/test_amr.py:39-52)."""
    cfg = read_config(str(fixtures_dir / "golden_amr_rk4_32.input"))
    cfg.output_file = str(tmp_path / "golden_amr_rk4_32.npz")
    cfg.simulation_file = str(fixtures_dir / "mock_amr.athdf")
    ours = pipeline.run(cfg, quiet=True, device="cpu")["I_nu"]
    gold = np.load(fixtures_dir / "golden_amr_rk4_32.npz")["I_nu"]
    assert np.array_equal(np.isnan(ours), np.isnan(gold))
    scale = np.nanmax(np.abs(gold))
    rel = np.abs(ours - gold) / (np.abs(gold) + scale * 1e-8)
    assert np.nanmax(rel) < 1e-8, np.nanmax(rel)


def test_formula_aux_images(fixtures_dir, tmp_path):
    """golden_formula_aux_32 (dp, 7000 steps) through the scan route, at
    the tolerances of tests/test_formula_e2e.py:38-69."""
    cfg = read_config(str(fixtures_dir / "golden_formula_aux_32.input"))
    cfg.output_file = str(tmp_path / "golden_formula_aux_32.npz")
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    gold = np.load(fixtures_dir / "golden_formula_aux_32.npz")
    for name, tol in (("time", 2e-2), ("length", 2e-2), ("lambda", 2e-2),
                      ("emission", 1e-2)):
        g = gold[name]
        rel = np.abs(arrays[name] - g) / (np.abs(g)
                                          + np.nanmax(np.abs(g)) * 1e-8)
        assert np.nanmax(rel) < tol, (name, np.nanmax(rel))
    # integer counts; a handful of pixels may differ by one where a
    # crossing lands within a sample spacing of a path's end
    assert np.mean(arrays["crossings"] != gold["crossings"]) < 0.02
    # tau is identically zero here (formula_a = 0)
    np.testing.assert_allclose(arrays["tau"], gold["tau"], atol=1e-300)


def test_thermal_tau_parity(fixtures_dir, tmp_path):
    """golden_sim_rk4_32.input with image_tau against
    golden_sim_tau_rk4_32 (tests/test_simulation_e2e.py:119-123)."""
    cfg = read_config(str(fixtures_dir / "golden_sim_rk4_32.input"))
    cfg.output_file = str(tmp_path / "golden_sim_tau_rk4_32.npz")
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.image_tau = True
    ours = pipeline.run(cfg, quiet=True, device="cpu")["tau"]
    gold = np.load(fixtures_dir / "golden_sim_tau_rk4_32.npz")["tau"]
    np.testing.assert_allclose(ours, gold, rtol=1e-8)


def test_simulation_dp_quadrature_parity(fixtures_dir, tmp_path):
    ours, gold = _render(fixtures_dir, tmp_path, "golden_sim_32")
    rel = np.abs(ours - gold) / (np.abs(gold) + gold.max() * 1e-8)
    assert np.nanmax(rel) < 6e-2
    assert np.nanmean(rel) < 5e-3


def test_simulation_cli_npz_matches_jax(fixtures_dir, tmp_path):
    """python -m blacklight_tpu_torch --device cpu on the rk4 simulation
    golden input writes the JAX package's npz, key for key, at rtol
    1e-8."""
    text = (fixtures_dir / "golden_sim_rk4_32.input").read_text().replace(
        "data/mock_small.athdf", str(fixtures_dir / "mock_small.athdf"))
    inputs = {}
    for name in ("jax", "torch"):
        inputs[name] = tmp_path / f"{name}.input"
        inputs[name].write_text(text.replace(
            "output/golden_sim_rk4_32.npz", str(tmp_path / f"{name}.npz")))
    jax_pipeline.run(jax_read_config(str(inputs["jax"])), quiet=True)
    assert cli.main(["--device", "cpu", str(inputs["torch"])]) == 0
    ours, ref = np.load(tmp_path / "torch.npz"), np.load(tmp_path / "jax.npz")
    assert set(ours.keys()) == set(ref.keys())
    for key in ref.keys():
        assert ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-8,
                                   atol=1e-14 * np.nanmax(np.abs(ref[key])),
                                   err_msg=key)


STOKES_RTOL = {"I_nu": 1e-8, "Q_nu": 1e-6, "U_nu": 1e-7, "V_nu": 1e-6}


def test_polarized_rk4_cli_exact_parity(fixtures_dir, tmp_path):
    """python -m blacklight_tpu_torch --device cpu on the rk4 polarized
    golden input writes I, Q, U and V at the tolerances of
    test_polarized_e2e.py:28-42 (each channel's floor its peak x 1e-4)."""
    text = (fixtures_dir / "golden_polarized_rk4_32.input").read_text()
    text = text.replace("data/mock_small.athdf",
                        str(fixtures_dir / "mock_small.athdf")).replace(
        "output/golden_polarized_rk4_32.npz", str(tmp_path / "pol.npz"))
    (tmp_path / "pol.input").write_text(text)
    assert cli.main(["--device", "cpu", str(tmp_path / "pol.input")]) == 0
    ours = np.load(tmp_path / "pol.npz")
    gold = np.load(fixtures_dir / "golden_polarized_rk4_32.npz")
    i_scale = np.nanmax(np.abs(gold["I_nu"]))
    for key, tol in STOKES_RTOL.items():
        g = gold[key]
        floor = max(np.nanmax(np.abs(g)) * 1e-4, i_scale * 1e-8)
        rel = np.abs(ours[key] - g) / (np.abs(g) + floor)
        assert np.nanmax(rel) < tol, (key, np.nanmax(rel))


def test_polarized_dp_quadrature_parity(fixtures_dir, tmp_path):
    """test_polarized_e2e.py:53-61: I pointwise, Q/U/V as fractions of
    I's peak."""
    cfg = read_config(str(fixtures_dir / "golden_polarized_32.input"))
    cfg.output_file = str(tmp_path / "pol_dp.npz")
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    gold = np.load(fixtures_dir / "golden_polarized_32.npz")
    i_scale = np.nanmax(np.abs(gold["I_nu"]))
    rel_i = np.abs(arrays["I_nu"] - gold["I_nu"]) \
        / (np.abs(gold["I_nu"]) + i_scale * 1e-8)
    assert np.nanmax(rel_i) < 6e-2
    for key in ("Q_nu", "U_nu", "V_nu"):
        frac = np.abs(arrays[key] - gold[key]) / i_scale
        assert np.nanmean(frac) < 5e-3, key
        assert np.nanmax(frac) < 1e-1, key


# ---- the power-law and kappa populations (ROADMAP B.2) ---------------------

@pytest.mark.parametrize("name", ["golden_plasma_pow_rk4_32",
                                  "golden_plasma_kap_rk4_32",
                                  "golden_plasma_mix_rk4_32"])
def test_plasma_rk4_exact_parity(fixtures_dir, tmp_path, name):
    """Power law, kappa (no kappa absorption unpolarized, the reference's
    quirk) and the thermal + power-law + kappa mixture at rtol 1e-8
    (tests/test_simulation_e2e.py:88-101). golden_plasma_mix_rk4_32 has
    no JAX test; the JAX package reproduces it at 1.2e-12."""
    ours, gold = _render(fixtures_dir, tmp_path, name)
    assert np.array_equal(np.isnan(ours), np.isnan(gold))
    np.testing.assert_allclose(ours, gold, rtol=1e-8)


def test_plasma_mix_polarized_parity(fixtures_dir, tmp_path):
    """The mixture through the polarized transfer, at
    tests/test_simulation_e2e.py:104-114's tolerances."""
    cfg = read_config(str(fixtures_dir / "golden_plasma_mix_pol_rk4_32.input"))
    cfg.output_file = str(tmp_path / "mix_pol.npz")
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    gold = np.load(fixtures_dir / "golden_plasma_mix_pol_rk4_32.npz")
    iscale = np.nanmax(np.abs(gold["I_nu"]))
    for key, tol in (("I_nu", 1e-7), ("Q_nu", 1e-3), ("U_nu", 1e-3),
                     ("V_nu", 1e-3)):
        rel = np.abs(arrays[key] - gold[key]) / (np.abs(gold[key])
                                                 + iscale * 1e-8)
        assert np.nanmax(rel) < tol, (key, np.nanmax(rel))


def test_plasma_kappa_tau_parity(fixtures_dir, tmp_path):
    """golden_plasma_kap_tau_rk4_32 (I_nu, emission and tau; no .input
    and no JAX test): golden_plasma_kap_rk4_32.input with image_emission
    and image_tau, the scan route, at rtol 1e-8 on every plane. The JAX
    package reproduces it with that configuration at 2.4e-12."""
    cfg = read_config(str(fixtures_dir / "golden_plasma_kap_rk4_32.input"))
    cfg.output_file = str(tmp_path / "kap_tau.npz")
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.image_emission = True
    cfg.image_tau = True
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    gold = np.load(fixtures_dir / "golden_plasma_kap_tau_rk4_32.npz")
    for key in ("I_nu", "emission", "tau"):
        assert np.array_equal(np.isnan(arrays[key]), np.isnan(gold[key])), key
        np.testing.assert_allclose(arrays[key], gold[key], rtol=1e-8,
                                   err_msg=key)


def test_code_kappa_golden_parity(fixtures_dir, tmp_path):
    """golden_code_kappa_32: the electron temperature from the snapshot's
    electron entropy (plasma_model = code_kappa, ROADMAP B.2) on
    write_athena's mock with its "kappa" slice, written at test time as
    tests/test_reference_goldens.py:70-85 writes it: identical NaN sets,
    rtol 1e-8 over a floor of 1e-8 of the peak."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
    import generate_mock_simulation as gen
    p = dict(gen.DEFAULTS)
    gen.write_athena(str(tmp_path / "mock.athdf"), gen.make_fields(p), p,
                     kappa=True)
    cfg = read_config(str(fixtures_dir / "golden_code_kappa_32.input"))
    cfg.simulation_file = str(tmp_path / "mock.athdf")
    cfg.output_file = str(tmp_path / "out.npz")
    ours = pipeline.run(cfg, quiet=True, device="cpu")["I_nu"]
    gold = np.load(fixtures_dir / "golden_code_kappa_32.npz")["I_nu"]
    scale = np.nanmax(np.abs(gold))
    rel = np.abs(ours - gold) / (np.abs(gold) + scale * 1e-8)
    assert np.array_equal(np.isnan(ours), np.isnan(gold))
    assert np.nanmax(rel) < 1e-8, np.nanmax(rel)


def test_adaptive_golden_parity(fixtures_dir, tmp_path):
    """golden_adaptive_32 (one level of blocks of 8 refined by the
    Laplacian criterion) on write_athena's mock, written at test time,
    with the gates of tests/test_reference_goldens.py:21-49: equal
    adaptive_num_levels and adaptive_num_blocks, the same refined
    locations, and the root and every refined block within rtol 1e-8 over
    a floor of 1e-8 of the root's peak."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
    import generate_mock_simulation as gen
    p = dict(gen.DEFAULTS)
    gen.write_athena(str(tmp_path / "mock.athdf"), gen.make_fields(p), p)
    cfg = read_config(str(fixtures_dir / "golden_adaptive_32.input"))
    cfg.simulation_file = str(tmp_path / "mock.athdf")
    cfg.output_file = str(tmp_path / "out.npz")
    ours = pipeline.run(cfg, quiet=True, device="cpu")
    ref = np.load(fixtures_dir / "golden_adaptive_32.npz")
    np.testing.assert_array_equal(ours["adaptive_num_levels"],
                                  ref["adaptive_num_levels"])
    np.testing.assert_array_equal(ours["adaptive_num_blocks"],
                                  ref["adaptive_num_blocks"])
    assert ref["adaptive_num_levels"][0] == 1
    scale = np.nanmax(np.abs(ref["I_nu"]))
    rel = np.abs(ours["I_nu"] - ref["I_nu"]) / (np.abs(ref["I_nu"])
                                                + scale * 1e-8)
    assert np.nanmax(rel) < 1e-8, np.nanmax(rel)
    o_map = {tuple(v): i for i, v in enumerate(ours["adaptive_block_locs_1"])}
    r_map = {tuple(v): i for i, v in enumerate(ref["adaptive_block_locs_1"])}
    assert set(o_map) == set(r_map)
    for loc, oi in o_map.items():
        a = ours["adaptive_I_nu_1"][oi]
        b = ref["adaptive_I_nu_1"][r_map[loc]]
        rel = np.abs(a - b) / (np.abs(b) + scale * 1e-8)
        assert np.nanmax(rel) < 1e-8, (loc, np.nanmax(rel))


def test_rendering_rk4_exact_parity(fixtures_dir, tmp_path):
    """golden_render_rk4_32 (fill rho, fill sigma, thresh beta_inverse;
    image_light = false) through the scan route with its renderings
    (ROADMAP D.1): rtol 1e-8 over 1e-10 of the peak
    (tests/test_render_truecolor.py:16-24)."""
    cfg = read_config(str(fixtures_dir / "golden_render_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.output_file = str(tmp_path / "r.npz")
    gold = np.load(fixtures_dir / "golden_render_rk4_32.npz")["rendering"]
    ours = pipeline.run(cfg, quiet=True, device="cpu")["rendering"]
    assert ours.shape == gold.shape
    np.testing.assert_allclose(ours, gold, rtol=1e-8,
                               atol=np.abs(gold).max() * 1e-10)


def test_rendering_dp_quadrature_parity(fixtures_dir, tmp_path):
    """golden_render_32 (dp): threshold crossings are binary events
    sensitive to sample placement, so agreement is statistical: mean
    error < 5e-3 and max < 2e-1 of the peak
    (tests/test_render_truecolor.py:27-34)."""
    cfg = read_config(str(fixtures_dir / "golden_render_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.output_file = str(tmp_path / "r.npz")
    gold = np.load(fixtures_dir / "golden_render_32.npz")["rendering"]
    ours = pipeline.run(cfg, quiet=True, device="cpu")["rendering"]
    err = np.abs(ours.reshape(gold.shape) - gold) / np.abs(gold).max()
    assert np.nanmean(err) < 5e-3
    assert np.nanmax(err) < 2e-1


def test_true_color_rk4_exact_parity(fixtures_dir, tmp_path):
    """golden_true_color_rk4_32: ten lin-wave frequencies through the
    kernel route, rtol 1e-8, with the npz's shape and frequencies
    (tests/test_render_truecolor.py:37-56)."""
    cfg = read_config(str(fixtures_dir / "golden_true_color_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.output_file = str(tmp_path / "tc.npz")
    pipeline.run(cfg, quiet=True, device="cpu")
    data = np.load(tmp_path / "tc.npz")
    gold = np.load(fixtures_dir / "golden_true_color_rk4_32.npz")
    assert data["I_nu"].shape == (10, 32, 32)
    np.testing.assert_allclose(data["I_nu"], gold["I_nu"], rtol=1e-8)
    np.testing.assert_allclose(data["frequency"], gold["frequency"])


def test_pinhole_golden_parity(fixtures_dir, tmp_path):
    """golden_pinhole_32: the pinhole camera (camera.cpp:608-671), rk4, on
    write_athena's mock written at test time as
    tests/test_reference_goldens.py:52-67 writes it: identical NaN sets,
    rtol 1e-8 over a floor of 1e-8 of the peak."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
    import generate_mock_simulation as gen
    p = dict(gen.DEFAULTS)
    gen.write_athena(str(tmp_path / "mock.athdf"), gen.make_fields(p), p)
    cfg = read_config(str(fixtures_dir / "golden_pinhole_32.input"))
    cfg.simulation_file = str(tmp_path / "mock.athdf")
    cfg.output_file = str(tmp_path / "out.npz")
    ours = pipeline.run(cfg, quiet=True, device="cpu")["I_nu"]
    ref = np.load(fixtures_dir / "golden_pinhole_32.npz")["I_nu"]
    scale = np.nanmax(np.abs(ref))
    rel = np.abs(ours - ref) / (np.abs(ref) + scale * 1e-8)
    assert np.array_equal(np.isnan(ours), np.isnan(ref))
    assert np.nanmax(rel) < 1e-8, np.nanmax(rel)
