"""PyTorch port: run(), the CLI, the slice guard and import hygiene."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import read_config as jax_read_config
from blacklight_tpu_torch import (BlacklightError, cli, parse_config,
                                  pipeline, read_config)

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
    arrays = jax_pipeline.run(jax_read_config(str(inp)), quiet=True)
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
                 checkpoint_geodesic_save="true",
                 checkpoint_geodesic_file=tmp_path / "g.npz")
    assert cli.main(["--device", "cpu", str(inp)]) == 1
    assert "A.8" in capsys.readouterr().err
    assert cli.main(["--device", "cpu", str(tmp_path / "missing")]) == 1


def test_cuda_device_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_config(_input(tmp_path / "a.input",
                              tmp_path / "a.npz").read_text())
    with pytest.raises(BlacklightError, match="cuda"):
        pipeline.run(cfg, quiet=True, device="cuda")
    assert not (tmp_path / "a.npz").exists()


def test_formula_polarization_warns_and_renders(jax_reference, tmp_path,
                                                capsys):
    """image_polarization on the formula model is ignored with the JAX
    package's warning, and the image is the unpolarized one."""
    _, ref_arrays, _ = jax_reference
    cfg = read_config(str(_input(tmp_path / "pol.input",
                                 tmp_path / "pol.npz")))
    cfg.image_polarization = True
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    assert "Ignoring image_polarization selection." in capsys.readouterr().err
    _assert_same_npz(arrays, ref_arrays)


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
# error must name; a simulation configuration without its simulation
# options (every snapshot format is read) with the error of the first
# option it lacks; adaptive configurations and a rendering the JAX package
# refuses, with its errors (blacklight_tpu/adaptive.py:56-58,
# output.py:43-46)
OUT_OF_SLICE = {
    "simulation": ({"model_type": "simulation", "image_polarization": False},
                   "Must specify simulation_multiple"),
    "adaptive_block_size": ({"adaptive_max_level": 1,
                             "adaptive_block_size": 5},
                            "adaptive_block_size must divide "
                            "camera_resolution."),
    "adaptive_npy": ({"adaptive_max_level": 1, "output_format": "npy"},
                     "Only npz outputs support adaptive ray tracing."),
    "geodesic_save": ({"checkpoint_geodesic_save": True,
                       "checkpoint_geodesic_file": "g.npz"}, "A.8"),
    "geodesic_load": ({"checkpoint_geodesic_load": True,
                       "checkpoint_geodesic_file": "g.npz"}, "A.8"),
    "sample_save": ({"checkpoint_sample_save": True}, "A.8"),
    "sample_load": ({"checkpoint_sample_load": True}, "A.8"),
    "rendering": ({"render_num_images": 1, "output_format": "npy"},
                  "Only npz outputs support rendering."),
}


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_out_of_slice_config_raises(tmp_path, case):
    overrides, item = OUT_OF_SLICE[case]
    cfg = parse_config(_input(tmp_path / "x.input",
                              tmp_path / "x.npz").read_text())
    for key, value in overrides.items():
        if key == "model_type":
            from blacklight_tpu_torch.constants import ModelType
            value = ModelType(value)
        elif key == "output_format":
            from blacklight_tpu_torch.constants import OutputFormat
            value = OutputFormat(value)
        setattr(cfg, key, value)
    with pytest.raises(BlacklightError, match=item):
        pipeline.run(cfg, quiet=True, device="cpu")
    assert not (tmp_path / "x.npz").exists()


def test_import_does_not_load_jax(tmp_path):
    """In a fresh interpreter: import every module of the port and its
    CLI, render an 8^2 formula image on the CPU, and find neither jax nor
    any module of the JAX package in sys.modules."""
    inp = _input(tmp_path / "run.input", tmp_path / "run.npz")
    code = (
        "import importlib, pkgutil, sys\n"
        "import blacklight_tpu_torch\n"
        "for m in pkgutil.walk_packages(blacklight_tpu_torch.__path__,\n"
        "                               'blacklight_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):  # runs the CLI\n"
        "        importlib.import_module(m.name)\n"
        "import blacklight_tpu_torch.cli\n"
        "assert 'blacklight_tpu_torch.grid.athenak' in sys.modules\n"
        "assert 'blacklight_tpu_torch.transfer.rendering' in sys.modules\n"
        "from blacklight_tpu_torch import pipeline, read_config\n"
        f"cfg = read_config({str(inp)!r})\n"
        "cfg.camera_resolution = 8\n"
        "arrays = pipeline.run(cfg, quiet=True, device='cpu')\n"
        "assert arrays['I_nu'].shape == (8, 8)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "loaded = [m for m in sys.modules if m == 'blacklight_tpu'\n"
        "          or m.startswith('blacklight_tpu.')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    result = subprocess.run([sys.executable, "-c", code], capture_output=True,
                            text=True, env=env, timeout=300, cwd=tmp_path)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip().splitlines()[-1] == "ok"


def test_package_source_never_imports_jax():
    """No import statement of the port, of chip_smoke.py or of the card's
    tests names jax or the JAX package."""
    paths = [*(REPO / "blacklight_tpu_torch").rglob("*.py"),
             REPO / "chip_smoke.py",
             *(REPO / "tests").glob("test_torch_*_cuda.py")]
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if len(words) < 2 or words[0] not in ("import", "from"):
                continue
            names = [w.strip(",") for w in words[1:]] if words[0] == "import" \
                else [words[1]]
            for name in names:
                assert name.split(".")[0] not in ("jax", "blacklight_tpu"), \
                    (path, line)
