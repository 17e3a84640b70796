"""PyTorch port: plasma_model = code_kappa (ROADMAP B.2) against the JAX
package.

The electron temperature from the snapshot's electron entropy, a ninth
sampled primitive (models/synchrotron.py fluid_state,
simulation_coefficients.cpp:351-358): the fluid state on seeded samples
(float64: theta_e and kb_tt_e_cgs at rtol 1e-12; float32 at
FLOAT32_RTOL with a floor of FLOAT32_RTOL of the largest value, the
port's thermal gate, tests/test_torch_synchrotron.py: the cube root's
form, |x|^(1/3) against jnp.cbrt, adds up to ~4e-6 to theta_e there);
the sampler's kappa channel in every mode (one block, the nearest cell,
four phi blocks, exact interblock sampling, FMKS and an AthenaK grid's) at rtol 1e-12 in float64, with its off-grid fallback
and its positivity repair; each loader's kappa slot (Athena++, AthenaK,
iharm3d, harm3d) bit for bit; and pipeline.run(device="cpu") and the
CLI against the JAX package's render at 8^2 (4^2 polarized) with 300
steps of 0.04, rk4 float64, at rtol 1e-8 with equal NaN sets (polarized: I, Q, U at 1e-8
and V at 1e-5 over a floor of 1e-4 of each channel's peak, as
tests/test_torch_loaders.py holds them), unpolarized in every snapshot
format, polarized, and mixed with power-law and kappa electrons.

The mocks hold kappa = KAPPA_SCALE * pgas / rho^gamma_adi (write_athena's
field, scaled so that theta_e spans ~0.2-3, where the images are not
vanishingly small), with KAPPA_NEGATIVE of the cells negative so that
interpolation meets the repair.
"""

import dataclasses
import functools
import pathlib
import re
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blacklight_tpu.constants import PlasmaModel as JaxPlasmaModel
from blacklight_tpu.grid import athena as jax_athena
from blacklight_tpu.grid import athenak as jax_athenak
from blacklight_tpu.grid import harm3d as jax_harm3d
from blacklight_tpu.grid import iharm3d as jax_iharm3d
from blacklight_tpu.grid import mks as jax_mks
from blacklight_tpu.grid import sampling as jax_sampling
from blacklight_tpu.grid.amr import with_amr_table as jax_with_amr_table
from blacklight_tpu.models import synchrotron as jsyn
from blacklight_tpu.pipeline_simulation import render_simulation_image
from blacklight_tpu.utils.config import parse_config as jax_parse_config
from blacklight_tpu.utils.errors import BlacklightError as JaxBlacklightError
from blacklight_tpu_torch import BlacklightError, cli, parse_config, pipeline
from blacklight_tpu_torch import interop
from blacklight_tpu_torch.constants import PlasmaModel
from blacklight_tpu_torch.grid import athena, athenak, harm3d, iharm3d, mks
from blacklight_tpu_torch.grid import sampling
from blacklight_tpu_torch.grid.amr import with_amr_table
from blacklight_tpu_torch.models import synchrotron
from blacklight_tpu_torch.ops import simulation_kernel as sk

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
import generate_mock_simulation as gen  # noqa: E402
import mock_athenak  # noqa: E402
from test_loaders import BASE_CONFIG  # noqa: E402

torch.set_num_threads(2)

FLOAT32_RTOL = 2e-5
KAPPA_SCALE = mock_athenak.KAPPA_SCALE
KAPPA_NEGATIVE = 0.05
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
RTOL = {"I_nu": 1e-8, "Q_nu": 1e-8, "U_nu": 1e-8, "V_nu": 1e-5}
# The snapshots' formats: name -> (simulation_format, simulation_coord,
# the kappa slot's variable)
FORMATS = {"athena": ("athena", "sks", "kappa"),
           "four": ("athena", "sks", "kappa"),
           "athenak": ("athenak", "cks", "kappa"),
           "iharm3d": ("iharm3d", "sks", "KAPPA"),
           "fmks": ("iharm3d", "fmks", "KAPPA"),
           "harm3d": ("harm3d", "sks", "kappa")}
# AthenaK's mock: write_blocks' 22 blocks on two levels with a kappa column
ATHENAK_LAYOUT = dict(root=2, cells=8, refine=((0, 0, 0), (1, 1, 1)),
                      kappa_scale=KAPPA_SCALE)


def _kappa(rho, pgas, rng):
    kappa = KAPPA_SCALE * pgas / rho ** gen.DEFAULTS["gamma_adi"]
    return np.where(rng.random(kappa.shape) < KAPPA_NEGATIVE, -kappa, kappa)


@pytest.fixture(scope="module")
def mocks(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_code_kappa")
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    rng = np.random.default_rng(14)
    paths = {"dir": d}
    for key, blocks in (("athena", 1), ("four", 4)):
        paths[key] = d / f"{key}.athdf"
        gen.write_athena(str(paths[key]), fields, p, kappa=True,
                         phi_blocks=blocks)
        with h5py.File(paths[key], "r+") as f:
            names = [n.decode() for n in f.attrs["VariableNames"]]
            prim = f["prim"][...]
            q = names.index("kappa")
            prim[q] = _kappa(prim[names.index("rho")],
                             prim[names.index("press")], rng)
            f["prim"][...] = prim
    paths["athenak"] = d / "athenak.bin"
    mock_athenak.write_blocks(str(paths["athenak"]), p, **ATHENAK_LAYOUT)
    kappa = _kappa(fields["rho"], fields["pgas"], rng)   # (ph, th, r)
    for key, writer in (("iharm3d", gen.write_iharm3d),
                        ("fmks", gen.write_iharm3d_fmks)):
        paths[key] = d / f"{key}.h5"
        writer(str(paths[key]), fields, p)
        with h5py.File(paths[key], "r+") as f:
            prims = f["prims"][...]                       # (r, th, ph, 8)
            names = list(f["header/prim_names"][...])
            del f["prims"], f["header/prim_names"]
            f["prims"] = np.concatenate(
                [prims, kappa.transpose(2, 1, 0)[..., None]],
                axis=-1).astype(prims.dtype)
            f["header/prim_names"] = np.array(names + [b"KAPPA"])
    paths["harm3d"] = d / "mock.harm"
    gen.write_harm3d(str(paths["harm3d"]), fields, p)
    with open(paths["harm3d"], "rb") as f:
        header = f.readline()
        table = np.fromfile(f, dtype=np.float32).reshape(
            p["n_r"], p["n_th"], p["n_ph"], -1)
    with open(paths["harm3d"], "wb") as f:
        f.write(header)
        np.concatenate([table, kappa.transpose(2, 1, 0)[..., None]],
                       axis=-1).astype(np.float32).tofile(f)
    return paths


def _text(paths, key, out=None, **overrides):
    """BASE_CONFIG on snapshot ``key`` with code_kappa electrons at 8^2,
    300 steps of 0.04, and ``overrides`` (key = value)."""
    fmt, coord, kappa_name = FORMATS[key]
    text = BASE_CONFIG.format(fmt=fmt, path=paths[key], coord=coord,
                              out=out or paths["dir"] / "out.npz")
    settings = {"plasma_model": "code_kappa", "camera_resolution": 8,
                "ray_step": 0.04, "ray_max_steps": 300,
                **({"simulation_kappa_name": kappa_name} if kappa_name
                   else {}), **overrides}
    for name, value in settings.items():
        line = f"{name} = {value}"
        text, n = re.subn(rf"^{name}\s*=.*$", line, text, flags=re.M)
        if n == 0:
            text += line + "\n"
    return text


def _load_both(paths, key):
    """The snapshot ``key`` through each package's loader, float64."""
    text = _text(paths, key)
    fmt, _, kappa_name = FORMATS[key]
    path = str(paths[key])
    if fmt == "athena":
        return (athena.load_athdf(path, kappa_name, device="cpu"),
                jax_athena.load_athdf(path, kappa_name=kappa_name))
    if fmt == "athenak":
        return (athenak.load_athenak(path, kappa_name, device="cpu"),
                jax_athenak.load_athenak(path, kappa_name=kappa_name))
    if fmt == "iharm3d":
        return (iharm3d.load_iharm3d(path, parse_config(text), device="cpu"),
                jax_iharm3d.load_iharm3d(path, jax_parse_config(text)))
    return (harm3d.load_harm3d(path, parse_config(text), device="cpu"),
            jax_harm3d.load_harm3d(path, jax_parse_config(text)))


# ---- the fluid state --------------------------------------------------------

@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_fluid_state_matches_jax(precision):
    """theta_e and kb_tt_e_cgs (and the rest of the state, which the
    temperature does not touch) of code_kappa against the JAX package's:
    samples over a snapshot's range, exact-zero fallback cells and cells
    of zero or negative entropy."""
    rng = np.random.default_rng(3)
    n = 2000
    r = rng.uniform(2.0, 50.0, n)
    th = np.arccos(rng.uniform(-0.98, 0.98, n))
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([np.zeros(n), r * np.sin(th) * np.cos(ph),
                    r * np.sin(th) * np.sin(ph), r * np.cos(th)], axis=-1)
    samples = {"rho": 10.0 ** rng.uniform(-8, 0, n),
               "pgas": 10.0 ** rng.uniform(-10, -1, n),
               "kappa": 10.0 ** rng.uniform(-4, 9, n),
               "uu1": rng.normal(0.0, 0.3, n), "uu2": rng.normal(0.0, 0.02, n),
               "uu3": rng.normal(0.0, 0.05, n),
               "bb1": rng.normal(0.0, 0.1, n), "bb2": rng.normal(0.0, 0.005, n),
               "bb3": rng.normal(0.0, 0.02, n)}
    samples["rho"][::41] = 0.0
    samples["kappa"][1::37] = 0.0
    samples["kappa"][2::43] *= -1.0
    plasma = jsyn.PlasmaParams(mu=0.5, ne_ni=1.0,
                               model=JaxPlasmaModel.code_kappa)
    p = pos.astype(precision)
    s = {k: v.astype(precision) for k, v in samples.items()}
    ours = synchrotron.fluid_state(
        torch.from_numpy(p), {k: torch.from_numpy(v) for k, v in s.items()},
        0.7, interop.plasma_params_from_jax(plasma), 1.0e-16)
    jdtype = jnp.float64 if precision == "float64" else jnp.float32
    ref = jsyn.fluid_state(jnp.asarray(p, jdtype),
                           {k: jnp.asarray(v, jdtype) for k, v in s.items()},
                           0.7, plasma, 1.0e-16)
    rtol = 1e-12 if precision == "float64" else FLOAT32_RTOL
    theta = ours["theta_e"].numpy()
    assert (theta > 0.0).any() and (theta == 0.0).any()
    for key in ("theta_e", "kb_tt_e_cgs", "rho_cgs", "n_e_cgs", "beta_inv"):
        a, b = ours[key].numpy().astype(np.float64), np.asarray(
            ref[key], np.float64)
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        scale = np.nanmax(np.abs(b))
        # the thermal test's floor: rtol of the largest |value| (float32's
        # 0.2 (sqrt(1 + 25 c^2) - 1) cancels for cold cells, in both)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                   equal_nan=True, err_msg=key)


def test_ti_te_beta_fluid_state_reads_no_kappa():
    """ti_te_beta ignores a kappa sample; code_kappa without one raises."""
    rng = np.random.default_rng(4)
    samples = {k: torch.from_numpy(rng.uniform(0.1, 1.0, 16)) for k in (
        "rho", "pgas", "uu1", "uu2", "uu3", "bb1", "bb2", "bb3")}
    pos = torch.from_numpy(np.stack([np.zeros(16), *rng.uniform(
        5.0, 9.0, (3, 16))], axis=-1))
    thermal = synchrotron.PlasmaParams(mu=0.5, ne_ni=1.0,
                                       model=PlasmaModel.ti_te_beta)
    a = synchrotron.fluid_state(pos, samples, 0.5, thermal, 1e-16)
    b = synchrotron.fluid_state(pos, {**samples, "kappa": samples["rho"]},
                                0.5, thermal, 1e-16)
    assert torch.equal(a["theta_e"], b["theta_e"])
    with pytest.raises(KeyError):
        synchrotron.fluid_state(pos, samples, 0.5, dataclasses.replace(
            thermal, model=PlasmaModel.code_kappa), 1e-16)


# ---- the loaders' kappa slot and the sampler's channel ---------------------

@pytest.mark.parametrize("key", ["athena", "athenak", "iharm3d", "harm3d"])
def test_loaders_read_the_kappa_slot(mocks, key):
    ours, ref = _load_both(mocks, key)
    assert ours.ind == ref.ind and "kappa" in ours.ind
    assert np.array_equal(ours.prim.numpy(), np.asarray(ref.prim))
    # the mocks' entropy where the writer did not negate it
    kappa = ours.prim[ours.ind["kappa"]]
    assert (kappa > 1e-3).any() and ((kappa < 0.0).any() or key == "athenak")


@pytest.mark.parametrize("key", ["athena", "iharm3d"])
def test_loaders_raise_without_the_slot(mocks, key):
    """A file without the named variable raises the JAX loader's error."""
    text = _text(mocks, key, simulation_kappa_name="entropy")
    with pytest.raises(JaxBlacklightError) as jax_err:
        render_simulation_image(jax_parse_config(text))
    with pytest.raises(BlacklightError) as err:
        pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert str(err.value) == str(jax_err.value)
    assert '"entropy"' in str(err.value)


def test_code_kappa_needs_the_slot_name_as_jax(mocks):
    """plasma_model = code_kappa without simulation_kappa_name raises the
    JAX package's error before the snapshot is read (the file here does
    not exist)."""
    text = re.sub(r"^simulation_kappa_name\s*=.*\n", "",
                  _text({**mocks, "athena": mocks["dir"] / "none.athdf"},
                        "athena"), flags=re.M)
    with pytest.raises(JaxBlacklightError) as jax_err:
        render_simulation_image(jax_parse_config(text))
    with pytest.raises(BlacklightError) as err:
        pipeline.run(parse_config(text), quiet=True, device="cpu")
    assert str(err.value) == str(jax_err.value) == (
        "Must specify simulation_kappa_name in input file for this "
        "configuration.")


# sampler modes: name -> (snapshot, SamplerOptions keywords)
SAMPLER_MODES = {
    "single": ("athena", dict(interp=True)),
    "nearest": ("athena", dict(interp=False)),
    "blocks": ("four", dict(interp=True)),
    "interblock": ("four", dict(interp=True, block_interp=True)),
    "fmks": ("fmks", dict(interp=True)),
    "cks": ("athenak", dict(interp=True, block_interp=True)),
}


@pytest.mark.parametrize("mode", sorted(SAMPLER_MODES))
def test_sampler_kappa_channel_matches_jax(mocks, mode, monkeypatch):
    """Every sampled value with the kappa channel at rtol 1e-12 in float64
    (rtol 1e-10 on the FMKS map, as tests/test_torch_loaders.py), off the
    grid the fallback, where an interpolated kappa is not positive the
    anchor cell's."""
    key, kw = SAMPLER_MODES[mode]
    if key == "fmks":
        # each package's inverse table at 256^2 in place of 2048^2, which
        # takes ~25 s a package on one host core
        for module in (jax_mks, mks):
            monkeypatch.setattr(module, "generate_sks_map", functools.partial(
                module.generate_sks_map, n1=256, n2=256))
    ours, ref = _load_both(mocks, key)
    if kw.get("block_interp"):
        ours, ref = with_amr_table(ours), jax_with_amr_table(ref)
    rng = np.random.default_rng(len(mode))
    n = 3000
    if key == "athenak":
        w = float(ours.host_faces[0].max())
        xyz = rng.uniform(-1.1 * w, 1.1 * w, (3, n))
    else:
        r = rng.uniform(1.5, 35.0, n)
        th = rng.uniform(0.0, np.pi, n)
        ph = rng.uniform(0.0, 2.0 * np.pi, n)
        xyz = np.stack([r * np.sin(th) * np.cos(ph),
                        r * np.sin(th) * np.sin(ph), r * np.cos(th)])
    pos = np.stack([np.zeros(n), *xyz], axis=-1)
    opts = dict(fallback_nan=False, fallback_rho=1e-3, fallback_pgas=2e-5,
                fallback_kappa=0.25, has_kappa=True, **kw)
    got = sampling.sample_grid(ours, torch.from_numpy(pos), 0.0,
                               sampling.SamplerOptions(**opts))
    want = jax_sampling.sample_grid(ref, jnp.asarray(pos), 0.0,
                                    jax_sampling.SamplerOptions(**opts))
    off = got["off_grid"].numpy()
    assert np.array_equal(off, np.asarray(want["off_grid"]))
    assert 0 < off.sum() < n
    kappa = got["kappa"].numpy()
    # the AthenaK mock's entropy is positive (scripts/mock_athenak.py)
    assert np.all(kappa[off] == 0.25) and (
        (kappa[~off] < 0.0).any() or key == "athenak")
    rtol = 1e-10 if key == "fmks" else 1e-12
    for name in sampling.sample_names(sampling.SamplerOptions(**opts)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=rtol, atol=0.0, err_msg=name)


def test_kernel_tables_carry_the_kappa_slot(mocks):
    """The kernels' kappa table is the grid's slot; the 8-value rows stay
    as they are; a grid without the slot is refused for code_kappa."""
    grid, _ = _load_both(mocks, "athena")
    opts = sampling.SamplerOptions(has_kappa=True)
    kgrid = sk.kernel_grid(grid, torch.float32, opts)
    assert torch.equal(kgrid.kappa, grid.prim[grid.ind["kappa"]])
    assert kgrid.table.shape[-1] == 8
    assert kgrid.mixture_args()[:-1] == kgrid.args()
    assert kgrid.mixture_args()[-1] == kgrid.kappa.data_ptr()
    assert sk.kernel_grid(grid, torch.float32).kappa is None
    bare = dataclasses.replace(grid, ind={k: v for k, v in grid.ind.items()
                                          if k != "kappa"})
    sk.check_grid(bare)
    with pytest.raises(ValueError, match="kappa"):
        sk.check_grid(bare, opts)


# ---- pipeline.run against the JAX package ----------------------------------

def _compare(ours, ref, keys, res):
    scale = np.nanmax(np.abs(np.asarray(ref["I_nu"])))
    assert scale > 0.0
    for key in keys:
        a = np.asarray(ours[key]).reshape(res, res)
        b = np.asarray(ref[key])[:, 0].reshape(res, res)
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        if key == "I_nu" and len(keys) == 1:
            np.testing.assert_allclose(a, b, rtol=1e-8,
                                       atol=1e-14 * scale, err_msg=key)
        else:
            floor = max(np.nanmax(np.abs(b)) * 1e-4, scale * 1e-8)
            rel = np.abs(a - b) / (np.abs(b) + floor)
            assert np.nanmax(rel) < RTOL[key], (key, np.nanmax(rel))


# case -> (snapshot, resolution, overrides, planes compared); Athena++
# unpolarized is the CLI's case below
RUNS = {
    "athena_polarized": ("athena", 4, {"image_polarization": "true",
                                       "image_rotation_split": "false"},
                         STOKES),
    "athena_mixture": ("athena", 8, {
        "plasma_power_frac": 0.3, "plasma_p": 3.5, "plasma_gamma_min": 30.0,
        "plasma_gamma_max": 1e4, "plasma_kappa_frac": 0.2,
        "plasma_kappa": 4.0, "plasma_w": 0.5}, ("I_nu",)),
    "athenak": ("athenak", 8, {"simulation_block_interp": "true"},
                ("I_nu",)),
    "iharm3d": ("iharm3d", 8, {}, ("I_nu",)),
    "harm3d": ("harm3d", 8, {}, ("I_nu",)),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_matches_jax(mocks, tmp_path, case):
    key, res, overrides, keys = RUNS[case]
    text = _text(mocks, key, tmp_path / "out.npz", camera_resolution=res,
                 **overrides)
    cfg = parse_config(text)
    assert cfg.plasma_model == PlasmaModel.code_kappa
    ref, *_ = render_simulation_image(jax_parse_config(text))
    ours = pipeline.run(cfg, quiet=True, device="cpu")
    _compare(ours, ref, keys, res)
    _compare(np.load(tmp_path / "out.npz"), ref, keys[:1], res)


def test_cli_renders_code_kappa(mocks, tmp_path, capsys):
    inp = tmp_path / "code_kappa.input"
    inp.write_text(_text(mocks, "athena", tmp_path / "cli.npz"))
    assert cli.main(["--device", "cpu", str(inp)]) == 0
    assert "Calculation completed." in capsys.readouterr().out
    ref, *_ = render_simulation_image(jax_parse_config(inp.read_text()))
    _compare(np.load(tmp_path / "cli.npz"), ref, ("I_nu",), 8)
