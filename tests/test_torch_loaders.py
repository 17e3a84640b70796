"""PyTorch port: the iharm3d (MKS and FMKS) and harm3d loaders, the FMKS
sampler and renders of those snapshots, against the JAX package.

The snapshots are scripts/generate_mock_simulation.py's torus at its
DEFAULTS size (32 x 16 x 8), written with h5py: the same file through
each package's loader gives the same grid (primitives bit for bit in
float32, coordinates and FMKS bounds at rtol 1e-12, the FMKS table at
atol 1e-12); the port's sampler on the FMKS grid gives the JAX
sampler's values (rtol 1e-10, float64, trilinear and nearest); and
pipeline.run on the CPU gives the JAX run's image at 16^2 with 400 steps
of 0.04 (rk4 float64, rtol 1e-8; polarized at 8^2 with the polarized
float64 gates: I, Q, U at rtol 1e-8, V at 1e-5). Then the port's own
versions of tests/test_loaders.py:188-241 (each format's image against
the Athena++ image of the same torus) and the refusals, before any
load, of what the port does not read yet (ROADMAP B.2) and of
coordinates a format does not have.

Each package's FMKS table (2048^2, 60 bisection rounds) is built once per
set of parameters here (a cache around generate_sks_map), not once per
load.
"""

import functools
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu.grid import harm3d as jax_harm3d
from blacklight_tpu.grid import iharm3d as jax_iharm3d
from blacklight_tpu.grid import mks as jax_mks
from blacklight_tpu.grid import sampling as jax_sampling
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu_torch import BlacklightError, parse_config, pipeline
from blacklight_tpu_torch.grid import harm3d, iharm3d, mks
from blacklight_tpu_torch.grid import sampling
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
import generate_mock_simulation as gen  # noqa: E402
from test_loaders import BASE_CONFIG  # noqa: E402

torch.set_num_threads(2)

STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
RTOL = {"I_nu": 1e-8, "Q_nu": 1e-8, "U_nu": 1e-8, "V_nu": 1e-5}
# The snapshots' formats: name -> (simulation_format, simulation_coord)
FORMATS = {"athena": ("athena", "sks"), "iharm3d": ("iharm3d", "sks"),
           "fmks": ("iharm3d", "fmks"), "harm3d": ("harm3d", "sks")}


@pytest.fixture(scope="module", autouse=True)
def cached_tables():
    """generate_sks_map of both packages, each table built once."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_mks, mks):
            mp.setattr(module, "generate_sks_map",
                       functools.cache(module.generate_sks_map))
        yield


@pytest.fixture(scope="module")
def mocks(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_loaders")
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    gen.write_athena(str(d / "mock.athdf"), fields, p)
    gen.write_iharm3d(str(d / "mock_iharm.h5"), fields, p)
    gen.write_iharm3d_fmks(str(d / "mock_fmks.h5"), fields, p)
    gen.write_harm3d(str(d / "mock.harm"), fields, p)
    return {"athena": d / "mock.athdf", "iharm3d": d / "mock_iharm.h5",
            "fmks": d / "mock_fmks.h5", "harm3d": d / "mock.harm",
            "dir": d}


def _text(paths, key, out=None, **overrides):
    """BASE_CONFIG on snapshot ``key`` at 16^2 with 400 steps of 0.04,
    and ``overrides`` (key = value, as in an input file)."""
    fmt, coord = FORMATS[key]
    text = BASE_CONFIG.format(fmt=fmt, path=paths[key], coord=coord,
                              out=out or paths["dir"] / "out.npz")
    settings = {"ray_step": 0.04, "ray_max_steps": 400, **overrides}
    for name, value in settings.items():
        line = f"{name} = {value}"
        text, n = re.subn(rf"^{name}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _load_both(paths, key):
    text = _text(paths, key)
    if key == "harm3d":
        ref = jax_harm3d.load_harm3d(str(paths[key]), jax_parse_config(text))
        ours = harm3d.load_harm3d(str(paths[key]), parse_config(text),
                                  device="cpu")
    else:
        ref = jax_iharm3d.load_iharm3d(str(paths[key]),
                                       jax_parse_config(text))
        ours = iharm3d.load_iharm3d(str(paths[key]), parse_config(text),
                                    device="cpu")
    return ours, ref


@pytest.mark.parametrize("key", ["iharm3d", "fmks", "harm3d"])
def test_loader_matches_jax(mocks, key):
    ours, ref = _load_both(mocks, key)
    assert ours.prim.dtype == torch.float32
    assert np.array_equal(ours.prim.numpy(), np.asarray(ref.prim))
    assert ours.ind == ref.ind and ours.time == ref.time
    for name in ("x1f", "x1v", "x2f", "x2v", "x3f", "x3v"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=0.0, err_msg=name)
    if key != "fmks":
        assert ours.sks_map is None and ours.bounds is None
        return
    np.testing.assert_allclose(ours.bounds, ref.bounds, rtol=1e-12)
    for name in ("map_r_in", "map_dr", "map_dtheta"):
        assert getattr(ours, name) == pytest.approx(getattr(ref, name),
                                                    rel=1e-12)
    assert ours.sks_map.shape == (2, mks.SKS_MAP_N2, mks.SKS_MAP_N1)
    np.testing.assert_allclose(ours.sks_map.numpy(),
                               np.asarray(ref.sks_map), rtol=0.0,
                               atol=1e-12)


def test_loader_in_float32(mocks):
    """Coordinates and the table in the working dtype; prim float32."""
    text = _text(mocks, "fmks")
    grid = iharm3d.load_iharm3d(str(mocks["fmks"]), parse_config(text),
                                device="cpu", dtype=torch.float32)
    assert grid.prim.dtype == torch.float32
    assert grid.x1f.dtype == grid.sks_map.dtype == torch.float32
    ref = iharm3d.load_iharm3d(str(mocks["fmks"]), parse_config(text),
                               device="cpu")
    assert torch.equal(grid.sks_map, ref.sks_map.to(torch.float32))


def test_read_iharm3d_is_h5py(mocks):
    """The port's reader gives every dataset that h5py reads."""
    import h5py
    datasets = iharm3d.read_iharm3d(str(mocks["fmks"]))
    with h5py.File(mocks["fmks"], "r") as f:
        names = []
        f.visititems(lambda name, obj: names.append(name)
                     if isinstance(obj, h5py.Dataset) else None)
        assert sorted(names) == sorted(datasets)
        for name in names:
            assert np.array_equal(datasets[name], np.asarray(f[name])), name


def test_iharm3d_grid_leaves_its_datasets(mocks):
    """iharm3d_grid converts a copy of the primitives: the datasets it is
    given (here with prims in Fortran order, as an in-memory recording of
    the mock writer holds them) are unchanged, and a second grid from
    them is the first's."""
    text = _text(mocks, "iharm3d")
    datasets = iharm3d.read_iharm3d(str(mocks["iharm3d"]))
    datasets["prims"] = np.asfortranarray(datasets["prims"])
    before = datasets["prims"].copy()
    first = iharm3d.iharm3d_grid(datasets, parse_config(text), device="cpu")
    assert np.array_equal(datasets["prims"], before)
    second = iharm3d.iharm3d_grid(datasets, parse_config(text), device="cpu")
    assert torch.equal(first.prim, second.prim)


@pytest.mark.parametrize("key", ["iharm3d", "fmks"])
def test_recorded_datasets_are_the_files(mocks, key):
    """scripts/mock_iharm3d_datasets.record_datasets (the card's stand-in
    for h5py) gives the datasets of the file the writer writes with
    h5py, with the same dtypes."""
    from mock_iharm3d_datasets import record_datasets
    p = dict(gen.DEFAULTS)
    writer = gen.write_iharm3d_fmks if key == "fmks" else gen.write_iharm3d
    recorded = record_datasets(writer, gen.make_fields(p), p)
    read = iharm3d.read_iharm3d(str(mocks[key]))
    assert sorted(recorded) == sorted(read)
    for name, value in read.items():
        assert recorded[name].dtype == value.dtype, name
        assert np.array_equal(recorded[name], value), name


def test_fmks_map_roundtrip():
    """The port's inverse table composed with the forward theta formula
    is the identity to table resolution (tests/test_loaders.py
    test_fmks_map_roundtrip), and it is the JAX package's table."""
    p = mks.FmksParams(h=0.3, r_in=2.0, poly_xt=0.82, poly_alpha=14.0,
                       mks_smooth=0.5)
    table, dr, dth = mks.generate_sks_map(p, 2.0, 30.0, n1=256, n2=256)
    table = table.numpy()
    th_target = np.minimum(dth * np.arange(256), np.pi)
    r_back, th_back = mks.fmks_sks_coords(table[0], table[1], p)
    np.testing.assert_allclose(r_back, np.broadcast_to(
        2.0 + dr * np.arange(256)[None, :], (256, 256)), rtol=1e-12)
    np.testing.assert_allclose(th_back, np.broadcast_to(
        th_target[:, None], (256, 256)), atol=1e-9)
    ref, dr_ref, dth_ref = jax_mks.generate_sks_map(
        jax_mks.FmksParams(**vars(p)), 2.0, 30.0, n1=256, n2=256)
    assert (dr, dth) == (dr_ref, dth_ref)
    np.testing.assert_allclose(table, ref, rtol=0.0, atol=1e-12)


@pytest.mark.parametrize("interp", [True, False],
                         ids=["trilinear", "nearest"])
def test_fmks_sampler_matches_jax(mocks, interp):
    """sample_grid at points across the FMKS grid, its edges and poles
    and off it, against the JAX sampler (float64)."""
    import jax.numpy as jnp
    ours, ref = _load_both(mocks, "fmks")
    rng = np.random.default_rng(7)
    n = 4096
    r = rng.uniform(1.5, 35.0, n)
    th = rng.uniform(-0.01, np.pi + 0.01, n)
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    th[:16], th[16:32] = 0.0, np.pi
    pos = np.stack([np.zeros(n), r * np.sin(th) * np.cos(ph),
                    r * np.sin(th) * np.sin(ph), r * np.cos(th)], axis=1)
    got = sampling.sample_grid(ours, torch.as_tensor(pos), 0.0,
                               sampling.SamplerOptions(interp=interp))
    want = jax_sampling.sample_grid(ref, jnp.asarray(pos), 0.0,
                                    jax_sampling.SamplerOptions(
                                        interp=interp))
    off = got["off_grid"].numpy()
    assert np.array_equal(off, np.asarray(want["off_grid"]))
    assert 0 < off.sum() < n
    for name in sampling.SAMPLE_NAMES:
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), rtol=1e-10,
                                   atol=0.0, err_msg=name)


def test_fmks_sampling_mode(mocks):
    """FMKS is its own mode with the nearest cell as a flag, takes the
    guide of a single block, and the map's values follow the axes in the
    launch's host array; an FMKS grid of two blocks raises."""
    import dataclasses
    grid, _ = _load_both(mocks, "fmks")
    for interp in (True, False):
        opts = sampling.SamplerOptions(interp=interp)
        assert sampling.sampling_mode(grid, opts) == sampling.FMKS
        kgrid = sk.kernel_grid(grid, torch.float32, opts)
        assert kgrid.mode == sampling.FMKS and kgrid.nearest == (not interp)
        assert kgrid.map.dtype == torch.float32 and kgrid.map.is_contiguous()
        tail = kgrid.axes[3 * sk.GUIDE_AXIS_VALUES:]
        assert len(tail) == sk.FMKS_MAP_VALUES
        assert list(tail) == [grid.map_r_in, grid.map_dr, grid.map_dtheta,
                              *grid.bounds, mks.SKS_MAP_N1, mks.SKS_MAP_N2]
        assert kgrid.args()[-1] == kgrid.map.data_ptr()
    single, _ = _load_both(mocks, "iharm3d")
    assert sk.kernel_grid(single, torch.float64).map is None
    assert sk.kernel_grid(single, torch.float64).args()[-1] is None
    two = dataclasses.replace(grid, prim=grid.prim.expand(
        -1, 2, -1, -1, -1))
    with pytest.raises(ValueError, match="one block"):
        sampling.sampling_mode(two, sampling.SamplerOptions())


# name -> (snapshot, overrides)
RUNS = {
    "iharm3d_mks": ("iharm3d", {}),
    "iharm3d_fmks": ("fmks", {}),
    "iharm3d_fmks_nearest": ("fmks", {"simulation_interp": "false"}),
    "iharm3d_fmks_dp": ("fmks", {"ray_integrator": "dp",
                                 "ray_max_retries": 20,
                                 "ray_tol_abs": "1.0e-8",
                                 "ray_tol_rel": "1.0e-8"}),
    "harm3d": ("harm3d", {}),
    "iharm3d_fmks_polarized": ("fmks", {
        "image_polarization": "true", "image_rotation_split": "false",
        "camera_resolution": 8}),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_matches_jax(mocks, tmp_path, case):
    """pipeline.run on the CPU (each file read by the port's loader)
    against the JAX run on the same input, float64."""
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
        floor = max(np.nanmax(np.abs(b)) * 1e-4, i_scale * 1e-8) \
            if name != "I_nu" else 0.0
        rel = np.abs(a - b) / (np.abs(b) + floor)
        assert np.nanmax(rel) < RTOL[name], (name, np.nanmax(rel))


def test_fmks_scan_route_matches_jax(mocks, tmp_path):
    """An auxiliary plane takes the scan route, which samples the FMKS
    grid through the same sampler: I and tau against the JAX run."""
    text = _text(mocks, "fmks", tmp_path / "out.npz", image_tau="true",
                 camera_resolution=8)
    ref = jax_pipeline.run(jax_parse_config(text), quiet=True)
    ours = pipeline.run(parse_config(text), quiet=True, device="cpu")
    for name in ("I_nu", "tau"):
        a, b = np.asarray(ours[name]), np.asarray(ref[name])
        assert a.shape == b.shape, name
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0.0, err_msg=name)


def _image(paths, key, **overrides):
    arrays = pipeline.run(parse_config(_text(paths, key, **overrides)),
                          quiet=True, device="cpu")
    return np.asarray(arrays["I_nu"]).reshape(16, 16)


@pytest.mark.parametrize("key", ["iharm3d", "harm3d"])
def test_image_matches_athena(mocks, key):
    """The same torus on the same grid in another format gives the
    Athena++ image (tests/test_loaders.py:188-200)."""
    image_a = _image(mocks, "athena")
    image_k = _image(mocks, key)
    np.testing.assert_allclose(image_k, image_a,
                               atol=1e-5 * np.nanmax(image_a))


def test_image_fmks_matches_athena_grid_aligned(tmp_path):
    """With mks_smooth = 0 the FMKS theta map does not depend on x^1, so
    an Athena++ file can hold the same collocation points; nearest
    sampling then takes the same cells in both
    (tests/test_loaders.py:203-229)."""
    p = dict(gen.DEFAULTS)
    params = mks.FmksParams(h=0.3, r_in=p["r_min"], poly_xt=0.82,
                            poly_alpha=14.0, mks_smooth=0.0)
    x2f = np.linspace(0.0, 1.0, p["n_th"] + 1)
    x2v = 0.5 * (x2f[:-1] + x2f[1:])
    _, thf = mks.fmks_sks_coords(np.zeros_like(x2f), x2f, params)
    _, thv = mks.fmks_sks_coords(np.zeros_like(x2v), x2v, params)
    fields = gen.make_fields(p, thf=thf, thv=thv)
    gen.write_athena(str(tmp_path / "m.athdf"), fields, p)
    gen.write_iharm3d_fmks(str(tmp_path / "f.h5"), fields, p, hslope=0.3,
                           mks_smooth=0.0)
    paths = {"athena": tmp_path / "m.athdf", "fmks": tmp_path / "f.h5",
             "dir": tmp_path}
    image_a = _image(paths, "athena", simulation_interp="false")
    image_f = _image(paths, "fmks", simulation_interp="false")
    np.testing.assert_allclose(image_f, image_a,
                               atol=2e-5 * np.nanmax(image_a))


# name -> (overrides, the error, raised before any load): the ROADMAP
# item a refusal names, or a loader's coordinate check (the JAX package's
# message). AthenaK is read: its loader opens the (missing) file.
REFUSED = {
    "athenak": ({"simulation_format": "athenak",
                 "simulation_coord": "cks"}, FileNotFoundError, None),
    "cks": ({"simulation_coord": "cks"}, BlacklightError,
            "Invalid simulation_coord for Harm format."),
    "harm3d_cks": ({"simulation_format": "harm3d",
                    "simulation_coord": "cks"}, BlacklightError,
                   "Invalid simulation_coord for Harm format."),
    # code_kappa without the kappa slot's variable: the JAX package's
    # error (blacklight_tpu/pipeline_simulation.py:118-120)
    "code_kappa": ({"plasma_model": "code_kappa"}, BlacklightError,
                   "Must specify simulation_kappa_name in input file for "
                   "this configuration."),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_before_any_load(tmp_path, case):
    """A loader's coordinate check raises, and so does code_kappa without
    simulation_kappa_name, before the (missing) file is opened; an
    AthenaK configuration passes both and fails opening it."""
    overrides, error, message = REFUSED[case]
    paths = {"iharm3d": tmp_path / "missing.h5", "dir": tmp_path}
    cfg = parse_config(_text(paths, "iharm3d", **overrides))
    with pytest.raises(error, match=re.escape(message) if message else None):
        pipeline.run(cfg, quiet=True, device="cpu")


def test_harm3d_takes_sks_only(mocks):
    """harm3d in FMKS raises the loader's error, as the JAX package's."""
    text = _text(mocks, "harm3d", simulation_coord="fmks")
    with pytest.raises(BlacklightError, match="Invalid simulation_coord"):
        pipeline.run(parse_config(text), quiet=True, device="cpu")
