"""PyTorch port: run(), the CLI, the slice guard and import hygiene."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu.utils.config import parse_config, read_config
from blacklight_tpu.utils.errors import BlacklightError
from blacklight_tpu_torch import cli, pipeline

from test_adaptive import CONFIG

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _input(path, out, res=16, **overrides):
    """Write a formula input file (test_adaptive.CONFIG, rk4, float64)."""
    text = CONFIG.format(out=str(out), res=res, max_level=0, num_regions=0,
                         regions="")
    text = text.replace("output_camera = false", "output_camera = true")
    for key, value in overrides.items():
        text += f"{key} = {value}\n"
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The JAX package's run() on a 16^2 rk4 float64 input."""
    d = tmp_path_factory.mktemp("jax_ref")
    inp = _input(d / "ref.input", d / "jax.npz")
    arrays = jax_pipeline.run(read_config(str(inp)), quiet=True)
    return inp, arrays, np.load(d / "jax.npz")


def _assert_same_npz(ours, ref):
    assert set(ours.keys()) == set(ref.keys())
    for key in ref.keys():
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape, key
        atol = 0.0
        if a.dtype.kind == "f":
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            # entries that are zero up to rounding (the camera's t = 0)
            atol = 1e-14 * np.nanmax(np.abs(b))
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=atol, err_msg=key)


def test_run_matches_jax_run(jax_reference, tmp_path):
    inp, ref_arrays, ref_file = jax_reference
    cfg = read_config(str(inp))
    cfg.output_file = str(tmp_path / "torch.npz")
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    assert np.nanmax(arrays["I_nu"]) > 0.0
    _assert_same_npz(arrays, ref_arrays)
    _assert_same_npz(np.load(tmp_path / "torch.npz"), ref_file)


def test_cli_cpu_writes_same_npz(jax_reference, tmp_path, capsys):
    _, _, ref_file = jax_reference
    inp = _input(tmp_path / "cli.input", tmp_path / "cli.npz")
    assert cli.main(["--device", "cpu", str(inp)]) == 0
    assert "Calculation completed." in capsys.readouterr().out
    _assert_same_npz(np.load(tmp_path / "cli.npz"), ref_file)


def test_cli_reports_errors(tmp_path, capsys):
    inp = _input(tmp_path / "bad.input", tmp_path / "bad.npz",
                 image_num_frequencies=2)
    assert cli.main(["--device", "cpu", str(inp)]) == 1
    assert "K1.3" in capsys.readouterr().err
    assert cli.main(["--device", "cpu", str(tmp_path / "missing")]) == 1


def test_cuda_device_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_config(_input(tmp_path / "a.input",
                              tmp_path / "a.npz").read_text())
    with pytest.raises(BlacklightError, match="cuda"):
        pipeline.run(cfg, quiet=True, device="cuda")
    assert not (tmp_path / "a.npz").exists()


def test_npy_output(tmp_path):
    inp = _input(tmp_path / "npy.input", tmp_path / "o.npy", res=4,
                 ray_max_steps=50)
    text = inp.read_text().replace("output_format = npz",
                                   "output_format = npy")
    cfg = parse_config(text)
    cfg.output_camera = False
    pipeline.run(cfg, quiet=True, device="cpu")
    assert np.load(tmp_path / "o.npy").shape == (1, 4, 4)


# Configurations outside the port's slice, each with the ROADMAP item its
# error must name
OUT_OF_SLICE = {
    "simulation": ({"model_type": "simulation", "image_polarization": False},
                   "ROADMAP B"),
    "no_light": ({"image_light": False}, "A.5"),
    "time": ({"image_time": True}, "A.5"),
    "length": ({"image_length": True}, "A.5"),
    "lambda": ({"image_lambda": True}, "A.5"),
    "emission": ({"image_emission": True}, "A.5"),
    "tau": ({"image_tau": True}, "A.5"),
    "lambda_ave": ({"image_lambda_ave": True}, "A.5"),
    "emission_ave": ({"image_emission_ave": True}, "A.5"),
    "tau_int": ({"image_tau_int": True}, "A.5"),
    "crossings": ({"image_crossings": True}, "A.5"),
    "frequencies": ({"image_num_frequencies": 3,
                     "image_frequency_start": 1e11,
                     "image_frequency_end": 4e11}, "K1.3"),
    "adaptive": ({"adaptive_max_level": 1}, "A.9"),
    "geodesic_save": ({"checkpoint_geodesic_save": True,
                       "checkpoint_geodesic_file": "g.npz"}, "A.8"),
    "geodesic_load": ({"checkpoint_geodesic_load": True,
                       "checkpoint_geodesic_file": "g.npz"}, "A.8"),
    "sample_save": ({"checkpoint_sample_save": True}, "A.8"),
    "sample_load": ({"checkpoint_sample_load": True}, "A.8"),
    "polarization": ({"image_polarization": True}, "C.1"),
    "rendering": ({"render_num_images": 1}, "D.1"),
}


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_out_of_slice_config_raises(tmp_path, case):
    overrides, item = OUT_OF_SLICE[case]
    cfg = parse_config(_input(tmp_path / "x.input",
                              tmp_path / "x.npz").read_text())
    for key, value in overrides.items():
        if key == "model_type":
            from blacklight_tpu.constants import ModelType
            value = ModelType(value)
        setattr(cfg, key, value)
    with pytest.raises(BlacklightError, match=item):
        pipeline.run(cfg, quiet=True, device="cpu")
    assert not (tmp_path / "x.npz").exists()


def test_import_does_not_load_jax():
    code = (
        "import sys\n"
        "import blacklight_tpu_torch\n"
        "import blacklight_tpu_torch.cli, blacklight_tpu_torch.pipeline\n"
        "import blacklight_tpu_torch.interop, blacklight_tpu_torch.camera\n"
        "import blacklight_tpu_torch.ops.formula_kernel\n"
        "import blacklight_tpu_torch.ops._build\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    result = subprocess.run([sys.executable, "-c", code], capture_output=True,
                            text=True, env=env, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


def test_package_source_never_imports_jax():
    for path in (REPO / "blacklight_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path
