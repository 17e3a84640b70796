"""PyTorch port: the CUDA polarized kernel against its plain PyTorch
version, on the card.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_polarized_kernel_cuda.py``. Without a GPU every test
skips. The plain version itself is held against the JAX package in
``test_torch_polarized_pipeline.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, pipeline, read_config
from blacklight_tpu_torch.constants import FrequencySpacing
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.pipeline_simulation import make_simulation_renderer

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
INPUT = FIXTURES / "golden_polarized_rk4_32.input"
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _config(res=16, **overrides):
    """The rk4 polarized golden input at res^2 with 400 steps of 0.04."""
    cfg = read_config(str(INPUT))
    cfg.simulation_file = str(FIXTURES / "mock_small.athdf")
    cfg.camera_resolution = res
    cfg.ray_step = 0.04
    cfg.ray_max_steps = 400
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def _args(integrator, precision, **overrides):
    cfg = _config(ray_integrator=RayIntegrator(integrator),
                  precision=precision, **overrides)
    render_fn, geom, rays, _, _ = make_simulation_renderer(cfg, device="cuda")
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, dict(render_fn.kernel_kwargs), geom


def _stokes(out, args, geom):
    nn_re, nn_im, flags, _, bad = out
    image = pk.poisoned_stokes(nn_re, nn_im, flags, bad, args[0], args[1],
                               args[3], args[4], geom, args[-1], True)
    return {k: v.cpu().numpy() for k, v in image.items()}


def _compare(args, kwargs, geom, exact, launches):
    before = pk.LAUNCHES
    out_k = pk.render_polarized(*args, **kwargs)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + launches
    out_p = pk.render_polarized_reference(*args, **kwargs)
    assert pk.LAUNCHES == before + launches
    for k_, p_ in zip(out_k, out_p):
        assert k_.shape == p_.shape and k_.dtype == p_.dtype
    ours, ref = _stokes(out_k, args, geom), _stokes(out_p, args, geom)
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    assert i_scale > 0.0
    for k in STOKES:
        assert np.array_equal(np.isnan(ours[k]), np.isnan(ref[k])), k
    if exact:
        assert torch.equal(out_k[2], out_p[2]) and torch.equal(out_k[3],
                                                               out_p[3])
        # V: the Faraday rotation amplifies the card's rounding of its
        # transcendentals (chip_smoke.py polarized_gate)
        for k, tol in (("I_nu", 1e-7), ("Q_nu", 1e-7), ("U_nu", 1e-7),
                       ("V_nu", 5e-5)):
            floor = max(np.nanmax(np.abs(ref[k])) * 1e-4, i_scale * 1e-8)
            rel = np.abs(ours[k] - ref[k]) / (np.abs(ref[k]) + floor)
            assert np.nanmax(rel) < tol, (k, np.nanmax(rel))
    else:
        for k in STOKES:
            frac = np.abs(ours[k] - ref[k]) / i_scale
            assert np.nanpercentile(frac, 99.5) < 1e-3, k
            assert np.nanmax(frac) < 1e-2, k


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("integrator", ["dp", "rk4", "rk2"])
def test_kernel_matches_plain(cuda_device, integrator, precision):
    """rk4 and rk2 in float64: flags, n_samples and NaN sets agree exactly,
    I, Q, U to rtol 1e-7 with the per-channel floor. dp and float32:
    identical NaN sets, every channel within 1e-2 of I's peak (1e-3 at the
    99.5th percentile)."""
    args, kwargs, geom = _args(integrator, precision)
    exact = integrator != "dp" and precision == "float64"
    _compare(args, kwargs, geom, exact, launches=1)


@pytest.mark.parametrize("rotation_split", [False, True])
def test_kernel_frequencies_and_split(cuda_device, rotation_split):
    """Six frequencies: two launches of at most MAX_FREQUENCIES, one
    image; both rotation_split regimes."""
    args, kwargs, geom = _args(
        "rk4", "float64", image_num_frequencies=6,
        image_frequency_start=1e11, image_frequency_end=6e11,
        image_frequency_spacing=FrequencySpacing.log,
        image_rotation_split=rotation_split)
    assert args[3].shape == (6,) and kwargs["rotation_split"] is rotation_split
    _compare(args, kwargs, geom, True, launches=2)


def test_kernel_window_chunks(cuda_device, monkeypatch):
    """A carry table too small for the bundle splits the rays into
    launches; another window size gives the same samples."""
    args, kwargs, geom = _args("rk4", "float64")
    ref = pk.render_polarized(*args, **kwargs)
    per_ray = pk.carry_bytes_per_ray(torch.float64, 400, pk.WINDOW)
    monkeypatch.setattr(pk, "CARRY_BYTES_MAX", 100 * per_ray)
    before = pk.LAUNCHES
    out = pk.render_polarized(*args, **kwargs)
    assert pk.LAUNCHES == before + 3  # 256 rays, 100 per launch
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # the samples and their order do not depend on the window
    for window in (17, 32):
        out = pk._render_cuda(*args, kwargs["integrator"],
                              kwargs["rotation_split"], window=window)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def test_pipeline_run_on_cuda(cuda_device, tmp_path):
    cfg = _config(res=8, output_file=str(tmp_path / "out.npz"))
    before = pk.LAUNCHES
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    assert pk.LAUNCHES == before + 1
    for k in STOKES:
        assert arrays[k].shape == (8, 8)
    assert np.isfinite(np.nanmax(arrays["I_nu"]))
    assert (tmp_path / "out.npz").exists()
