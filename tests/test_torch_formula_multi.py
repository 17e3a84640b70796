"""PyTorch port: formula images at several frequencies (K1.3).

The plain version of the fused formula kernel at three frequencies is held
against the JAX package's Pallas kernel in interpret mode and against its
XLA scan path, and ``pipeline.run`` and the CLI against the JAX ``run``,
on identical inputs carried across with ``interop``. The CUDA kernel is
held against the plain version on the card by
``test_torch_formula_kernel_cuda.py``.
"""

import numpy as np
import pytest
import torch

from blacklight_tpu import pipeline as jax_pipeline
from blacklight_tpu import read_config as jax_read_config
from blacklight_tpu.constants import FrequencySpacing
from blacklight_tpu.models import formula as jformula
from blacklight_tpu.ops.pallas_formula import render_formula as jax_render
from blacklight_tpu.transfer.unpolarized import (
    ImageOptions, integrate_unpolarized)
from blacklight_tpu_torch import cli, pipeline, read_config

from test_torch_formula_kernel import _setup, _port_args
from test_torch_pipeline import _assert_same_npz, _input

torch.set_num_threads(2)

# tests/test_pallas_kernel.py:78-82: three frequencies, log-spaced
FREQUENCIES = dict(image_num_frequencies=3, image_frequency_start=1.0e11,
                   image_frequency_end=4.0e11,
                   image_frequency_spacing=FrequencySpacing.log)
FREQUENCY_LINES = dict(image_num_frequencies=3, image_frequency_start=1.0e11,
                       image_frequency_end=4.0e11,
                       image_frequency_spacing="log")


@pytest.mark.parametrize("integrator,fallback_nan", [
    ("rk4", True), ("dp", False)])
def test_reference_matches_pallas_interpret(tmp_path, integrator,
                                            fallback_nan):
    """Plain float32 version at three frequencies against the Pallas
    kernel (interpret mode): identical NaN sets, flags and n_samples, and
    I within atol 1e-4 x its peak per frequency (the assertions of
    test_torch_formula_kernel.py:95-100)."""
    steps = dict(ray_max_steps=800, ray_tol_abs=1e-6, ray_tol_rel=1e-6,
                 ray_max_retries=20) if integrator == "dp" else \
        dict(ray_max_steps=600)
    s = _setup(tmp_path, integrator, 8, "float32", **steps, **FREQUENCIES)
    rays = s["rays"]
    i_ref, flags_ref, nsamp_ref = jax_render(
        rays.positions, rays.directions, rays.momentum_factors,
        np.asarray(s["freqs"]), s["params"], s["fparams"], s["mass_msun"],
        s["camera_x"], s["log_j_scale"], fallback_nan=fallback_nan,
        integrator=integrator, interpret=True)
    i_ref = np.asarray(i_ref)
    i_port, flags, nsamp = _port_render(s, integrator, fallback_nan)

    assert i_port.shape == i_ref.shape == (64, 3)
    assert np.array_equal(np.isnan(i_port), np.isnan(i_ref))
    assert np.array_equal(flags, np.asarray(flags_ref))
    assert np.array_equal(nsamp, np.asarray(nsamp_ref))
    for f in range(3):
        scale = np.nanmax(np.abs(i_ref[:, f]))
        assert scale > 0.0
        np.testing.assert_allclose(np.nan_to_num(i_port[:, f]),
                                   np.nan_to_num(i_ref[:, f]),
                                   atol=1e-4 * scale)


def _port_render(s, integrator, fallback_nan):
    from blacklight_tpu_torch.ops import formula_kernel as fk
    i_nu, flags, n_samp = fk.render_formula(
        *_port_args(s), fallback_nan=fallback_nan, integrator=integrator)
    return i_nu.numpy(), flags.numpy(), n_samp.numpy()


def test_reference_rk4_float64_matches_scan(tmp_path):
    """Plain float64 rk4 at three frequencies against the XLA scan path
    (integrate_unpolarized), at the repository's rk4 parity tolerance,
    rtol 1e-8, with exact flags and n_samples."""
    s = _setup(tmp_path, "rk4", 16, "float64", **FREQUENCIES)
    rays, fparams, freqs = s["rays"], s["fparams"], s["freqs"]

    def coeff_fn(pos, kcov):
        j, a, _, bad = jformula.formula_coefficients(
            pos, kcov, rays.momentum_factors, freqs, fparams, s["geom"].cam_x)
        return j, a, bad

    img = integrate_unpolarized(
        rays.positions, rays.directions, rays.momentum_factors, freqs,
        params=s["params"], coeff_fn=coeff_fn,
        opts=ImageOptions(fallback_nan=s["cfg"].fallback_nan),
        mass_msun=s["mass_msun"], camera_x=s["geom"].cam_x, early_exit=True,
        log_j_scale=s["log_j_scale"])
    i_ref = np.asarray(img["I_nu"])
    i_port, flags, nsamp = _port_render(s, "rk4", s["cfg"].fallback_nan)

    assert i_ref.shape == i_port.shape == (256, 3)
    assert np.all(np.nanmax(i_ref, axis=0) > 0.0)
    assert np.array_equal(np.isnan(i_port), np.isnan(i_ref))
    assert np.array_equal(flags, np.asarray(img["_flags"]))
    assert np.array_equal(nsamp, np.asarray(img["_n_samples"]))
    np.testing.assert_allclose(i_port, i_ref, rtol=1e-8)


def test_run_and_cli_match_jax_run(tmp_path, capsys):
    """pipeline.run and the CLI on a three-frequency formula input write
    the npz of the JAX run (rk4 float64, rtol 1e-8): I_nu (3, res, res)
    and the frequency table."""
    inp = _input(tmp_path / "ref.input", tmp_path / "jax.npz", res=8,
                 **FREQUENCY_LINES)
    ref = jax_pipeline.run(jax_read_config(str(inp)), quiet=True)
    cfg = read_config(str(inp))
    cfg.output_file = str(tmp_path / "torch.npz")
    arrays = pipeline.run(cfg, quiet=True, device="cpu")
    assert arrays["I_nu"].shape == (3, 8, 8)
    assert np.all(np.nanmax(arrays["I_nu"], axis=(1, 2)) > 0.0)
    _assert_same_npz(arrays, ref)
    _assert_same_npz(np.load(tmp_path / "torch.npz"),
                     np.load(tmp_path / "jax.npz"))

    cli_inp = _input(tmp_path / "cli.input", tmp_path / "cli.npz", res=8,
                     **FREQUENCY_LINES)
    assert cli.main(["--device", "cpu", str(cli_inp)]) == 0
    assert "Calculation completed." in capsys.readouterr().out
    _assert_same_npz(np.load(tmp_path / "cli.npz"),
                     np.load(tmp_path / "jax.npz"))
