"""PyTorch port: the FMKS instantiations of the simulation kernel, its
phase kernel and the polarized route's derive kernel (csrc/sim_sample.cuh
SAMPLE_FMKS) on the card, against their plain versions on the same rays.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_fmks_cuda.py``. Without a GPU every test skips. The
plain versions are held against the JAX package in
``test_torch_loaders.py``.

The snapshot is scripts/generate_mock_simulation.py's FMKS torus
(write_iharm3d_fmks) on mock_small.athdf's grid and radii (64 x 32 x 32),
recorded in memory (scripts/mock_iharm3d_datasets.py: the card's Python
has no h5py) and built by grid/iharm3d.iharm3d_grid; the cameras and
plasmas are golden_sim_rk4_32.input's and golden_plasma_mix_rk4_32.input's
with 400 steps of 0.04. Gates: rk4 in float64 exact (flags, sample counts
and NaN sets equal, rtol 1e-9), dp in float64 at rtol 1e-7; float32 at the
statistical gate of bench.py:181-186 (32^2); phased bit for bit the
monolithic image; the polarized route in float64 at rtol 1e-9 over a floor
of 1e-4 of each channel's peak (V at 5e-5), in float32 each channel's
|delta| within 1e-3 of I's peak at the 99.5th percentile and 1e-2 at the
most (16^2).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, read_config
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.constants import Coordinates, SimulationFormat
from blacklight_tpu_torch.grid import sampling
from blacklight_tpu_torch.grid.iharm3d import iharm3d_grid
from blacklight_tpu_torch.ops import polarized_kernel as pk
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT / "scripts"))
import generate_mock_simulation as gen  # noqa: E402
from mock_iharm3d_datasets import record_datasets  # noqa: E402

THERMAL = "golden_sim_rk4_32.input"
MIXTURE = "golden_plasma_mix_rk4_32.input"
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
# mock_small.athdf's grid and radii
GRID = dict(n_r=64, n_th=32, n_ph=32, r_min=1.916, r_max=52.2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def datasets():
    p = dict(gen.DEFAULTS, **GRID)
    return record_datasets(gen.write_iharm3d_fmks, gen.make_fields(p), p)


_GRIDS = {}


def _config(name, res, **overrides):
    cfg = read_config(str(FIXTURES / name))
    cfg.simulation_format = SimulationFormat.iharm3d
    cfg.simulation_coord = Coordinates.fmks
    cfg.camera_resolution = res
    cfg.ray_step = 0.04
    cfg.ray_max_steps = 400
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def _renderer(datasets, name, res=16, **overrides):
    cfg = _config(name, res, **overrides)
    dtype = torch.float32 if cfg.precision == "float32" else torch.float64
    if dtype not in _GRIDS:
        _GRIDS[dtype] = iharm3d_grid(datasets, cfg, device="cuda",
                                     dtype=dtype)
    render_fn, geom, rays, _, _ = \
        pipeline_simulation.make_simulation_renderer(cfg, device="cuda",
                                                     grid=_GRIDS[dtype])
    assert render_fn.kernel_args[3].sks_map is not None
    return render_fn, geom, rays


def _args(render_fn, rays):
    return (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)


def _exact(ours, ref, rtol):
    assert torch.equal(ours[1], ref[1]) and torch.equal(ours[2], ref[2])
    a, b = ours[0].cpu().numpy(), ref[0].cpu().numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(b) > 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0)


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels past
    1e-3 relative, total flux within 1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))


@pytest.mark.parametrize("population", ["thermal", "mixture"])
@pytest.mark.parametrize("interp", [True, False],
                         ids=["trilinear", "nearest"])
@pytest.mark.parametrize("integrator,precision", [
    ("rk4", "float64"), ("dp", "float64"), ("rk4", "float32"),
    ("dp", "float32")])
def test_fmks_kernel_matches_plain(cuda_device, datasets, integrator,
                                   precision, interp, population):
    """dp keeps the golden inputs' 2000 steps of 0.01 (a float32 dp ray
    whose step count nears a budget of 400 can end flagged in one version
    and not the other)."""
    steps = {} if integrator != "dp" else {"ray_step": 0.01,
                                           "ray_max_steps": 2000}
    render_fn, _, rays = _renderer(
        datasets, THERMAL if population == "thermal" else MIXTURE,
        res=16 if precision == "float64" else 32,
        ray_integrator=RayIntegrator(integrator), precision=precision,
        simulation_interp=interp, **steps)
    assert render_fn.route == "kernel"
    args = _args(render_fn, rays)
    counts = sk.MODE_LAUNCHES if population == "thermal" \
        else sk.MIXTURE_MODE_LAUNCHES
    before = (sk.LAUNCHES, list(counts))
    ours = sk.render_simulation(*args, integrator=integrator)
    assert sk.LAUNCHES == before[0] + 1
    assert counts[sampling.FMKS] == before[1][sampling.FMKS] + 1
    ref = sk.render_simulation_reference(*args, integrator=integrator)
    torch.cuda.synchronize()
    if precision == "float64":
        _exact(ours, ref, 1e-9 if integrator == "rk4" else 1e-7)
    else:
        _statistical_gate(ours[0].cpu().numpy()[:, 0],
                          ref[0].cpu().numpy()[:, 0])


@pytest.mark.parametrize("population", ["thermal", "mixture"])
@pytest.mark.parametrize("integrator,precision,interp", [
    ("rk4", "float64", True), ("rk2", "float32", True),
    ("rk4", "float32", False)])
def test_fmks_phased_matches_monolithic(cuda_device, datasets, integrator,
                                        precision, interp, population):
    """The FMKS phase kernel (phases of 100 steps) gives the FMKS kernel's
    image bit for bit."""
    render_fn, _, rays = _renderer(
        datasets, THERMAL if population == "thermal" else MIXTURE, res=32,
        ray_integrator=RayIntegrator(integrator), precision=precision,
        simulation_interp=interp)
    args = _args(render_fn, rays)
    mono = sk.render_simulation(*args, integrator=integrator)
    counts = sk.PHASE_MODE_LAUNCHES if population == "thermal" \
        else sk.PHASE_MIXTURE_MODE_LAUNCHES
    before = counts[sampling.FMKS]
    phased = sk.render_simulation_phased(*args, integrator=integrator,
                                         phase_steps=100, block=256)
    assert counts[sampling.FMKS] > before
    for a, b in zip(phased, mono):
        assert torch.equal(torch.nan_to_num(a, nan=-1.0),
                           torch.nan_to_num(b, nan=-1.0))


def test_fmks_phase_kernel_matches_plain(cuda_device, datasets):
    """One phase of the FMKS phase kernel from the same carried state as
    its plain version: rk4 float64, rtol 1e-9."""
    render_fn, _, rays = _renderer(datasets, THERMAL)
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js = \
        _args(render_fn, rays)
    outs = []
    for run in (sk.render_simulation_phase,
                sk.render_simulation_phase_reference):
        carry = sk.initial_carry(positions, directions, params,
                                 freqs.shape[0])
        index = torch.arange(positions.shape[0], dtype=torch.int32,
                             device=positions.device)
        run(carry, index, 0, 200, directions, mom, freqs, params, sp, grid,
            mass, cam, "rk4")
        outs.append(sk.finish_rays(carry, index, freqs, log_js, True))
    _exact(outs[0], outs[1], 1e-9)


def _stokes(render_fn, geom, rays, kernel):
    fn = pk.render_polarized if kernel else pk.render_polarized_reference
    nn_re, nn_im, flags, _, bad = fn(*_args(render_fn, rays),
                                     **render_fn.kernel_kwargs)
    return {k: v.double().cpu().numpy() for k, v in pk.poisoned_stokes(
        nn_re, nn_im, flags, bad, rays.positions, rays.directions,
        render_fn.kernel_args[0], render_fn.kernel_args[1], geom,
        render_fn.kernel_args[6], True).items()}


@pytest.mark.parametrize("population", ["thermal", "mixture"])
@pytest.mark.parametrize("precision,interp", [
    ("float64", True), ("float32", True), ("float64", False)])
def test_fmks_polarized_matches_plain(cuda_device, datasets, precision,
                                      interp, population):
    name = "golden_polarized_rk4_32.input" if population == "thermal" \
        else "golden_plasma_mix_pol_rk4_32.input"
    render_fn, geom, rays = _renderer(datasets, name, precision=precision,
                                      simulation_interp=interp)
    counts = pk.DERIVE_MODE_LAUNCHES if population == "thermal" \
        else pk.DERIVE_MIXTURE_MODE_LAUNCHES
    before = (list(pk.DERIVE_MODE_LAUNCHES),
              list(pk.DERIVE_MIXTURE_MODE_LAUNCHES))
    ours = _stokes(render_fn, geom, rays, True)
    assert counts[sampling.FMKS] > (before[0] if population == "thermal"
                                    else before[1])[sampling.FMKS]
    # no other derive instantiation
    other = pk.DERIVE_MIXTURE_MODE_LAUNCHES if population == "thermal" \
        else pk.DERIVE_MODE_LAUNCHES
    assert other == (before[1] if population == "thermal" else before[0])
    ref = _stokes(render_fn, geom, rays, False)
    i_scale = np.nanmax(np.abs(ref["I_nu"]))
    assert i_scale > 0.0
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
