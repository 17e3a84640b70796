"""PyTorch port: the AthenaK loader, Cartesian Kerr-Schild (CKS) sampling
and fluid state, and renders of AthenaK snapshots, against the JAX
package.

The snapshots are scripts/generate_mock_simulation.py's torus in
AthenaK's format: write_athenak's one block of 32^3 cells, and files of
scripts/mock_athenak.write_blocks (the same fields on a root grid of 2^3
blocks of 8^3 cells with two root blocks refined once: 22 blocks on two
levels; with float32 faces and float64 variables; with a kappa column).
The same file through each package's loader gives the same grid
(primitives bit for bit, faces and centres equal, the refinement
metadata and the neighbour table equal); the port's sampler and fluid
state give the JAX package's values at rtol 1e-12 (float64); and
pipeline.run on the CPU gives the JAX run's image at 16^2 with 400 steps
of 0.04 (rk4 float64, rtol 1e-8; polarized at 8^2 with I, Q, U at rtol
1e-8 and V at 1e-5 over a floor of 1e-4 of each channel's peak). Then the
errors and warnings of both loaders, the coordinate checks, and the
port's own version of tests/test_loaders.py:287-295 (the AthenaK image
against the Athena++ image of the same torus).
"""

import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu.constants import PlasmaModel as JaxPlasmaModel
from blacklight_tpu.grid import amr as jax_amr
from blacklight_tpu.grid import athenak as jax_athenak
from blacklight_tpu.grid import sampling as jax_sampling
from blacklight_tpu.models import synchrotron as jax_synchrotron
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu.utils.errors import BlacklightError as JaxBlacklightError
from blacklight_tpu_torch import BlacklightError, interop, parse_config
from blacklight_tpu_torch import pipeline
from blacklight_tpu_torch.grid import amr, athenak, sampling
from blacklight_tpu_torch.models import synchrotron
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
import generate_mock_simulation as gen  # noqa: E402
import mock_athenak  # noqa: E402
from test_loaders import BASE_CONFIG  # noqa: E402

torch.set_num_threads(2)

STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
RTOL = {"I_nu": 1e-8, "Q_nu": 1e-8, "U_nu": 1e-8, "V_nu": 1e-5}
AMR = dict(root=2, cells=8, refine=[(1, 1, 1), (0, 1, 0)])
# file -> write_blocks' keywords (None: write_athenak's own file)
FILES = {"mock": None, "amr": AMR,
         "f64_vars": dict(location_size=4, variable_size=8),
         "kappa": dict(AMR, extra_variables=("kappa_e",),
                       kappa_scale=mock_athenak.KAPPA_SCALE)}


@pytest.fixture(scope="module")
def mocks(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_athenak")
    p = dict(gen.DEFAULTS)
    paths = {"dir": d}
    for name, layout in FILES.items():
        paths[name] = d / f"{name}.bin"
        if layout is None:
            gen.write_athenak(str(paths[name]), gen.make_fields(p), p)
        else:
            mock_athenak.write_blocks(str(paths[name]), p, **layout)
    gen.write_athena(str(d / "mock.athdf"), gen.make_fields(p), p)
    paths["athena"] = d / "mock.athdf"
    return paths


def _text(paths, key, out=None, fmt="athenak", coord="cks", **overrides):
    """BASE_CONFIG on snapshot ``key`` at 16^2 with 400 steps of 0.04,
    and ``overrides`` (key = value, as in an input file)."""
    text = BASE_CONFIG.format(fmt=fmt, path=paths[key], coord=coord,
                              out=out or paths["dir"] / "out.npz")
    settings = {"ray_step": 0.04, "ray_max_steps": 400, **overrides}
    for name, value in settings.items():
        line = f"{name} = {value}"
        text, n = re.subn(rf"^{name}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _load_both(path, kappa_name=None, **kwargs):
    ours = athenak.load_athenak(str(path), kappa_name, device="cpu",
                                **kwargs)
    ref = jax_athenak.load_athenak(str(path), kappa_name, **kwargs)
    return ours, ref


def test_one_block_writer_is_write_athenak(mocks, tmp_path):
    """mock_athenak.write_blocks of one root block is write_athenak's
    file byte for byte, so its fields are that writer's."""
    path = tmp_path / "one.bin"
    mock_athenak.write_blocks(str(path), dict(gen.DEFAULTS))
    assert path.read_bytes() == mocks["mock"].read_bytes()


@pytest.mark.parametrize("key", sorted(FILES))
def test_loader_matches_jax(mocks, key):
    kappa_name = "kappa_e" if key == "kappa" else None
    ours, ref = _load_both(mocks[key], kappa_name)
    assert ours.coords == ref.coords == "cks"
    assert ours.prim.dtype == torch.float32
    assert np.array_equal(ours.prim.numpy(), np.asarray(ref.prim))
    assert ours.ind == ref.ind and ours.time == ref.time
    for name in ("x1f", "x1v", "x2f", "x2v", "x3f", "x3v"):
        assert np.array_equal(getattr(ours, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    assert np.array_equal(ours.levels, ref.levels)
    assert ours.levels.dtype == ref.levels.dtype
    assert np.array_equal(ours.locations, ref.locations)
    assert ours.locations.dtype == ref.locations.dtype
    assert ours.n3_root == 0 and ours.sks_map is None
    if key == "kappa":
        assert ours.ind["kappa"] == 8
    n_b = {"amr": 22, "kappa": 22}.get(key, 1)
    assert ours.n_blocks == n_b


def test_neighbor_table_matches_jax(mocks):
    """The two-level mock's neighbour table (no periodic axis) is the
    JAX package's, and differs from the table of a periodic third axis
    where the grid ends in z."""
    ours, ref = _load_both(mocks["amr"])
    ours = amr.with_amr_table(ours)
    ref = jax_amr.with_amr_table(ref)
    assert np.array_equal(ours.amr_table.numpy(), np.asarray(ref.amr_table))
    assert np.array_equal(ours.loc_parity.numpy(),
                          np.asarray(ref.loc_parity))
    periodic, _ = amr.build_neighbor_table(ours.levels, ours.locations,
                                           ours.prim.shape[2], 0,
                                           periodic_phi=True)
    assert not np.array_equal(periodic, ours.amr_table.numpy())


HEADER_CASES = ("version", "location_size", "variable_size", "time_line",
                "variable_count", "missing_variable", "missing_gamma",
                "truncated", "no_blocks")


def _header_variant(data: bytes, case: str) -> bytes:
    """A broken copy of an AthenaK file (one of HEADER_CASES)."""
    def sub(old, new):
        assert old in data
        return data.replace(old, new, 1)
    # the cell data start after the parameter section's last line
    data_offset = data.index(b"\n", data.index(b"gamma = ")) + 1
    return {
        "version": lambda: sub(b"version=1.1", b"version=2.0"),
        "location_size": lambda: sub(b"size of location=8",
                                     b"size of location=2"),
        "variable_size": lambda: sub(b"size of variable=4",
                                     b"size of variable=2"),
        "time_line": lambda: sub(b"  time=", b"  tyme="),
        "variable_count": lambda: sub(b"number of variables=8",
                                      b"number of variables=9"),
        "missing_variable": lambda: sub(b"  eint", b"  ener"),
        "missing_gamma": lambda: sub(b"gamma = ", b"gammb = "),
        "truncated": lambda: data[:-7],
        "no_blocks": lambda: data[:data_offset + 24],
    }[case]()


@pytest.mark.parametrize("case", HEADER_CASES)
def test_loader_errors_match_jax(mocks, tmp_path, case):
    """A broken header or record layout raises the JAX package's error,
    with its message."""
    path = tmp_path / f"{case}.bin"
    path.write_bytes(_header_variant(mocks["mock"].read_bytes(), case))
    with pytest.raises(JaxBlacklightError) as ref:
        jax_athenak.load_athenak(str(path))
    with pytest.raises(BlacklightError, match=re.escape(str(ref.value))):
        athenak.load_athenak(str(path), device="cpu")


def test_loader_warnings_match_jax(tmp_path, capfd):
    """A file whose parameters differ from the user's inputs warns, in
    the JAX package's words, and the user's adiabatic index wins."""
    path = tmp_path / "units.bin"
    mock_athenak.write_blocks(
        str(path), dict(gen.DEFAULTS), cells=8, spin=0.5,
        parameters="<units>\nbhmass_msun = 6.5e9\ndensity_cgs = 1e-17\n"
                   "mu = 0.6  # comment\n")
    expected = {"a": 0.0, "bhmass_msun": 4.152e6, "density_cgs": 1e-16,
                "mu": 0.5}
    kwargs = dict(plasma_gamma=5.0 / 3.0, expected=expected)
    capfd.readouterr()
    ref = jax_athenak.load_athenak(str(path), **kwargs)
    jax_err = capfd.readouterr().err
    ours = athenak.load_athenak(str(path), device="cpu", **kwargs)
    our_err = capfd.readouterr().err
    assert our_err == jax_err
    assert jax_err.count("Warning: ") == 5
    assert np.array_equal(ours.prim.numpy(), np.asarray(ref.prim))


def _points(n=4096, seed=11):
    """CKS points across the cube (half-width 21.2) and past it."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4))
    pos[:, 1:] = rng.uniform(-23.0, 23.0, (n, 3))
    pos[:64, 1:] = rng.uniform(-0.5, 0.5, (64, 3))   # near the centre
    return pos


@pytest.mark.parametrize("key,mode", [
    ("mock", "trilinear"), ("mock", "nearest"), ("amr", "trilinear"),
    ("amr", "nearest"), ("amr", "interblock")])
def test_sampler_matches_jax(mocks, key, mode):
    """sample_grid at CKS points of the grid and off it, against the JAX
    sampler (float64)."""
    ours, ref = _load_both(mocks[key])
    opts = dict(interp=mode != "nearest", block_interp=mode == "interblock")
    if mode == "interblock":
        ours, ref = amr.with_amr_table(ours), jax_amr.with_amr_table(ref)
    pos = _points()
    got = sampling.sample_grid(ours, torch.as_tensor(pos), 0.3,
                               sampling.SamplerOptions(**opts))
    want = jax_sampling.sample_grid(ref, jnp.asarray(pos), 0.3,
                                    jax_sampling.SamplerOptions(**opts))
    off = got["off_grid"].numpy()
    assert np.array_equal(off, np.asarray(want["off_grid"]))
    assert 0 < off.sum() < pos.shape[0] // 2
    for name in sampling.SAMPLE_NAMES:
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), rtol=1e-12,
                                   atol=0.0, err_msg=name)


@pytest.mark.parametrize("spin", [0.0, 0.9])
def test_fluid_state_cks_matches_jax(spin):
    """fluid_state in CKS (AthenaK's primitives) against the JAX
    package's, float64, rtol 1e-12 over a floor of 1e-12 of each value's
    largest magnitude."""
    rng = np.random.default_rng(3)
    n = 2000
    pos = np.zeros((n, 4))
    pos[:, 1:] = rng.uniform(-30.0, 30.0, (n, 3))
    samples = {"rho": 10.0 ** rng.uniform(-8, 0, n),
               "pgas": 10.0 ** rng.uniform(-10, -1, n),
               **{f"uu{i}": rng.normal(0.0, 0.2, n) for i in (1, 2, 3)},
               **{f"bb{i}": rng.normal(0.0, 0.05, n) for i in (1, 2, 3)}}
    for key in ("bb1", "bb2", "bb3"):
        samples[key][:50] = 0.0
    plasma = jax_synchrotron.PlasmaParams(
        mu=0.5, ne_ni=1.0, model=JaxPlasmaModel.ti_te_beta, use_p=True,
        rat_low=1.0, rat_high=10.0)
    ref = jax_synchrotron.fluid_state(
        jnp.asarray(pos), {k: jnp.asarray(v) for k, v in samples.items()},
        spin, plasma, 1e-16, coords="cks")
    ours = synchrotron.fluid_state(
        torch.as_tensor(pos), {k: torch.as_tensor(v)
                               for k, v in samples.items()},
        spin, interop.plasma_params_from_jax(plasma), 1e-16, coords="cks")
    for key in ("rho_cgs", "pgas_cgs", "n_e_cgs", "bb_cgs", "sigma",
                "beta_inv", "theta_e", "kb_tt_e_cgs", "b_sq"):
        b = np.asarray(ref[key])
        np.testing.assert_allclose(ours[key].numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(b)),
                                   err_msg=key)
    for key in ("ucon", "bcon"):
        b = np.asarray(ref[key])
        for c in range(4):
            np.testing.assert_allclose(
                ours[key][c].numpy(), b[:, c], rtol=1e-12,
                atol=1e-12 * np.max(np.abs(b[:, c])), err_msg=f"{key}{c}")


def test_kernel_modes(mocks):
    """A CKS grid takes the kernels' CKS modes: one block and many (and
    the nearest cell) CKS_BLOCKS, interblock sampling CKS_INTERBLOCK; the
    launch's bounds are the blocks' x, y and z faces and its axes the
    whole cube's."""
    one, _ = _load_both(mocks["mock"])
    grid = amr.with_amr_table(_load_both(mocks["amr"])[0])
    for g, opts, mode in (
            (one, sampling.SamplerOptions(), sk.CKS_BLOCKS),
            (one, sampling.SamplerOptions(interp=False), sk.CKS_BLOCKS),
            (grid, sampling.SamplerOptions(), sk.CKS_BLOCKS),
            (grid, sampling.SamplerOptions(block_interp=True),
             sk.CKS_INTERBLOCK)):
        sk.check_grid(g)
        kgrid = sk.kernel_grid(g, torch.float64, opts)
        assert kgrid.mode == mode and kgrid.nearest == (not opts.interp)
        assert (kgrid.amr is not None) == (mode == sk.CKS_INTERBLOCK)
        want = torch.stack([c for f in (g.x1f, g.x2f, g.x3f)
                            for c in (f[:, 0], f[:, -1])], dim=1)
        assert torch.equal(kgrid.bounds, want)
        half = 30.0 / np.sqrt(2.0)
        assert list(kgrid.axes[[0, 1, 4, 5, 8, 9]]) == [-half, half] * 3


# name -> (snapshot, overrides)
RUNS = {
    "one_block": ("mock", {}),
    "amr_interblock": ("amr", {"simulation_block_interp": "true"}),
    "amr_blocks": ("amr", {}),
    "nearest": ("amr", {"simulation_interp": "false"}),
    "mixture": ("amr", {"simulation_block_interp": "true",
                        "plasma_power_frac": 0.3, "plasma_kappa_frac": 0.2,
                        "plasma_p": 3.0, "plasma_gamma_min": 10.0,
                        "plasma_gamma_max": 1.0e4, "plasma_kappa": 4.0,
                        "plasma_w": 2.0}),
    "polarized": ("amr", {"simulation_block_interp": "true",
                          "image_polarization": "true",
                          "image_rotation_split": "false",
                          "camera_resolution": 8}),
    # samples between the cube (half-width 21.2) and r = 24 are off the
    # grid: NaN pixels
    "fallback_nan": ("mock", {"fallback_nan": "true", "cut_omit_out": 24.0}),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_matches_jax(mocks, tmp_path, case):
    """pipeline.run on the CPU (the file read by the port's loader)
    against the JAX run on the same input, float64, through the kernels'
    plain versions."""
    key, overrides = RUNS[case]
    text = _text(mocks, key, tmp_path / "out.npz", **overrides)
    ref = jax_pipeline.run(jax_parse_config(text), quiet=True)
    cfg = parse_config(text)
    launches = (sk.LAUNCHES, sk.PHASE_LAUNCHES, pk.LAUNCHES)
    ours = pipeline.run(cfg, quiet=True, device="cpu")
    assert (sk.LAUNCHES, sk.PHASE_LAUNCHES, pk.LAUNCHES) == launches
    res = cfg.camera_resolution
    keys = STOKES if cfg.image_polarization else ("I_nu",)
    i_scale = np.nanmax(np.abs(np.asarray(ref["I_nu"])))
    assert i_scale > 0.0
    for name in keys:
        a = np.asarray(ours[name]).reshape(-1, res * res)
        b = np.asarray(ref[name]).reshape(-1, res * res)
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        assert np.isfinite(b).mean() > 0.5, name
        assert np.isnan(b).any() == (case == "fallback_nan"), name
        floor = max(np.nanmax(np.abs(b)) * 1e-4, i_scale * 1e-8) \
            if name != "I_nu" else 0.0
        rel = np.abs(a - b) / (np.abs(b) + floor)
        assert np.nanmax(rel) < RTOL[name], (name, np.nanmax(rel))


def test_scan_route_matches_jax(mocks, tmp_path):
    """An auxiliary plane takes the scan route, which samples the CKS
    grid through the same sampler and fluid state: I and tau against the
    JAX run, interblock sampling on two levels."""
    text = _text(mocks, "amr", tmp_path / "out.npz", image_tau="true",
                 simulation_block_interp="true", camera_resolution=8)
    ref = jax_pipeline.run(jax_parse_config(text), quiet=True)
    ours = pipeline.run(parse_config(text), quiet=True, device="cpu")
    for name in ("I_nu", "tau"):
        a, b = np.asarray(ours[name]), np.asarray(ref[name])
        assert a.shape == b.shape, name
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0.0, err_msg=name)


# name -> (snapshot, simulation_format, simulation_coord, the error)
MISMATCHED = {
    "athena_cks": ("athena", "athena", "cks",
                   "simulation_coord does not match the loaded grid's "
                   "coordinates."),
    "athenak_sks": ("mock", "athenak", "sks",
                    "simulation_coord does not match the loaded grid's "
                    "coordinates."),
    "iharm3d_cks": ("athena", "iharm3d", "cks",
                    "Invalid simulation_coord for Harm format."),
}


@pytest.mark.parametrize("case", sorted(MISMATCHED))
def test_coordinate_mismatch_raises_as_jax(mocks, tmp_path, case):
    """A snapshot whose coordinates are not simulation_coord raises the
    JAX package's error in both packages, and nothing is written."""
    key, fmt, coord, message = MISMATCHED[case]
    text = _text(mocks, key, tmp_path / "out.npz", fmt=fmt, coord=coord)
    with pytest.raises(JaxBlacklightError, match=re.escape(message)):
        jax_pipeline.run(jax_parse_config(text), quiet=True)
    with pytest.raises(BlacklightError, match=re.escape(message)):
        pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert not (tmp_path / "out.npz").exists()


def test_code_kappa_renders_as_jax(mocks, tmp_path):
    """plasma_model = code_kappa on the AthenaK file with a kappa column
    (the electron entropy read from simulation_kappa_name: write_blocks'
    "kappa", scaled to theta_e ~0.2-3) against the JAX run: interblock
    sampling on two levels, rk4 float64, rtol 1e-8 with equal NaN
    sets."""
    text = _text(mocks, "kappa", tmp_path / "out.npz",
                 plasma_model="code_kappa", simulation_kappa_name="kappa",
                 simulation_block_interp="true", camera_resolution=8)
    ref = jax_pipeline.run(jax_parse_config(text), quiet=True)
    ours = pipeline.run(parse_config(text), quiet=True, device="cpu")
    a, b = np.asarray(ours["I_nu"]), np.asarray(ref["I_nu"])
    assert a.shape == b.shape == (8, 8)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(b) > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=0.0)


def test_image_matches_athena_loosely(mocks):
    """The AthenaK cube of the same torus gives the Athena++ image to the
    Cartesian grid's coarser discretization (tests/test_loaders.py
    :287-295), with the JAX test's bounds."""
    images = {}
    for key, fmt, coord in (("athena", "athena", "sks"),
                            ("mock", "athenak", "cks")):
        arrays = pipeline.run(parse_config(_text(
            mocks, key, fmt=fmt, coord=coord, ray_step=0.01,
            ray_max_steps=1200)), quiet=True, device="cpu")
        images[key] = np.asarray(arrays["I_nu"]).reshape(16, 16)
    i_a, i_k = images["athena"], images["mock"]
    assert np.nanmax(np.abs(i_k - i_a)) < 0.25 * np.nanmax(i_a)
    assert abs(np.nansum(i_k) - np.nansum(i_a)) < 0.08 * np.nansum(i_a)
