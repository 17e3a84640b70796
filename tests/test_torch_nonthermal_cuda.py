"""PyTorch port: the mixture instantiations of the simulation and
polarized kernels (thermal + power-law + kappa electrons, ROADMAP B.2) on
the card, against their plain versions on the same rays.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_nonthermal_cuda.py``. Without a GPU every test skips.
The plain versions are held against the JAX package in
``test_torch_nonthermal.py``.

Gates: rk4/rk2 in float64 exact (flags, sample counts and NaN sets equal,
rtol 1e-9); float32 and dp at the statistical gate of bench.py:181-186;
the polarized route in float64 at rtol 1e-9 over a floor of 1e-4 of each
channel's peak (V at 5e-5, chip_smoke.py V_EXACT_RTOL), in float32
chip_smoke.py polarized_gate's: each Stokes channel's |delta| within 1e-3
of I's peak at the 99.5th percentile and 1e-2 at the most, I's flux
within 1e-3. Images are 32^2 (polarized 16^2)
with 400 steps of 0.04 on mock_small.athdf (mock_amr.athdf for the modes
of many blocks).
"""

import pathlib

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, read_config
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.constants import FrequencySpacing
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
POPULATIONS = {"power": "golden_plasma_pow_rk4_32.input",
               "kappa": "golden_plasma_kap_rk4_32.input",
               "mix": "golden_plasma_mix_rk4_32.input"}
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _renderer(name, res=32, snapshot="mock_small.athdf", **overrides):
    cfg = read_config(str(FIXTURES / name))
    cfg.simulation_file = str(FIXTURES / snapshot)
    cfg.camera_resolution = res
    cfg.ray_step = 0.04
    cfg.ray_max_steps = 400
    for key, value in overrides.items():
        setattr(cfg, key, value)
    render_fn, geom, rays, _, _ = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cuda")
    return render_fn, geom, rays


def _exact(ours, ref):
    assert torch.equal(ours[1], ref[1]) and torch.equal(ours[2], ref[2])
    a, b = ours[0].cpu().numpy(), ref[0].cpu().numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(b) > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=0.0)


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels past
    1e-3 relative, total flux within 1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))


CASES = [("rk4", "float64", "power"), ("rk4", "float64", "kappa"),
         ("rk4", "float64", "mix"), ("rk2", "float64", "mix"),
         ("dp", "float64", "mix"), ("rk4", "float32", "mix"),
         ("dp", "float32", "mix")]


@pytest.mark.parametrize("integrator,precision,population", CASES)
def test_mixture_kernel_matches_plain(cuda_device, integrator, precision,
                                      population):
    """dp keeps the golden input's 2000 steps of 0.01, as the thermal
    kernel's dp checks do: a float32 dp ray whose step count nears a
    budget of 400 can end flagged in one version and not the other."""
    steps = {} if integrator != "dp" else {"ray_step": 0.01,
                                           "ray_max_steps": 2000}
    render_fn, _, rays = _renderer(
        POPULATIONS[population], ray_integrator=RayIntegrator(integrator),
        precision=precision, **steps)
    assert render_fn.route == "kernel"
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    before = (sk.LAUNCHES, sk.MIXTURE_LAUNCHES, list(sk.MODE_LAUNCHES))
    ours = sk.render_simulation(*args, integrator=integrator)
    assert sk.MIXTURE_LAUNCHES == before[1] + 1
    assert sk.LAUNCHES == before[0] + 1
    assert sk.MODE_LAUNCHES == before[2]  # no thermal kernel
    ref = sk.render_simulation_reference(*args, integrator=integrator)
    torch.cuda.synchronize()
    if precision == "float64" and integrator != "dp":
        _exact(ours, ref)
    else:
        _statistical_gate(ours[0].cpu().numpy()[:, 0],
                          ref[0].cpu().numpy()[:, 0])


@pytest.mark.parametrize("mode,overrides", [
    ("interblock", {"simulation_block_interp": True}),
    ("nearest", {"simulation_interp": False})])
def test_mixture_modes_match_plain(cuda_device, mode, overrides):
    """The mixture on mock_amr.athdf's two levels (exact interblock
    sampling, or the nearest cell), three frequencies, rk4 float64."""
    render_fn, _, rays = _renderer(
        POPULATIONS["mix"], snapshot="mock_amr.athdf", image_num_frequencies=3,
        image_frequency_start=1e11, image_frequency_end=6e11,
        image_frequency_spacing=FrequencySpacing("log"), **overrides)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    ours = sk.render_simulation(*args, integrator="rk4")
    ref = sk.render_simulation_reference(*args, integrator="rk4")
    assert ours[0].shape[1] == 3
    _exact(ours, ref)


@pytest.mark.parametrize("integrator,precision", [("rk4", "float64"),
                                                  ("rk2", "float32")])
def test_mixture_phased_matches_monolithic(cuda_device, integrator,
                                           precision):
    """The mixture's phase kernel (phases of 100 steps) gives the mixture
    kernel's image bit for bit."""
    render_fn, _, rays = _renderer(POPULATIONS["mix"],
                                   ray_integrator=RayIntegrator(integrator),
                                   precision=precision)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    mono = sk.render_simulation(*args, integrator=integrator)
    before = sk.PHASE_MIXTURE_LAUNCHES
    phased = sk.render_simulation_phased(*args, integrator=integrator,
                                         phase_steps=100, block=256)
    assert sk.PHASE_MIXTURE_LAUNCHES > before
    for a, b in zip(phased, mono):
        assert torch.equal(torch.nan_to_num(a, nan=-1.0),
                           torch.nan_to_num(b, nan=-1.0))


def _stokes(render_fn, geom, rays, kernel):
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    fn = pk.render_polarized if kernel else pk.render_polarized_reference
    nn_re, nn_im, flags, _, bad = fn(*args, **render_fn.kernel_kwargs)
    return {k: v.double().cpu().numpy() for k, v in pk.poisoned_stokes(
        nn_re, nn_im, flags, bad, rays.positions, rays.directions,
        render_fn.kernel_args[0], render_fn.kernel_args[1], geom,
        render_fn.kernel_args[6], True).items()}


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_mixture_polarized_matches_plain(cuda_device, precision):
    render_fn, geom, rays = _renderer("golden_plasma_mix_pol_rk4_32.input",
                                      res=16, precision=precision)
    before = (pk.DERIVE_MIXTURE_LAUNCHES, list(pk.DERIVE_MODE_LAUNCHES))
    ours = _stokes(render_fn, geom, rays, True)
    assert pk.DERIVE_MIXTURE_LAUNCHES > before[0]
    assert pk.DERIVE_MODE_LAUNCHES == before[1]
    ref = _stokes(render_fn, geom, rays, False)
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    for key in STOKES:
        a, b = ours[key], ref[key]
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        if precision == "float64":
            floor = np.nanmax(np.abs(b)) * 1e-4
            rtol = 5e-5 if key == "V_nu" else 1e-9
            assert np.nanmax(np.abs(a - b) / (np.abs(b) + floor)) < rtol, key
        else:
            frac = np.abs(a - b) / i_scale
            assert np.nanpercentile(frac, 99.5) < 1e-3, key
            assert np.nanmax(frac) < 1e-2, key
    if precision == "float32":
        flux = np.nansum(ours["I_nu"])
        assert abs(flux - np.nansum(ref["I_nu"])) < 1e-3 * abs(flux)


def test_thermal_configuration_launches_no_mixture(cuda_device):
    render_fn, _, rays = _renderer("golden_sim_rk4_32.input", res=8)
    before = sk.MIXTURE_LAUNCHES
    render_fn(rays.positions, rays.directions, rays.momentum_factors)
    assert sk.MIXTURE_LAUNCHES == before
