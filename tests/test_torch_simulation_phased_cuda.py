"""PyTorch port: the CUDA phase kernel of phased dispatch (K2.3) on the
card, against the monolithic CUDA kernel and its own plain version.

This file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_simulation_phased_cuda.py``. Without a GPU every test
skips. The plain phased render is held against the JAX package in
``test_torch_simulation_phased.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from blacklight_tpu_torch import RayIntegrator, pipeline, read_config
from blacklight_tpu_torch import pipeline_simulation
from blacklight_tpu_torch.constants import FrequencySpacing
from blacklight_tpu_torch.ops import simulation_kernel as sk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
INPUT = FIXTURES / "golden_sim_rk4_32.input"
PHASE_STEPS = 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _config(res=32, **overrides):
    cfg = read_config(str(INPUT))
    cfg.simulation_file = str(FIXTURES / "mock_small.athdf")
    cfg.camera_resolution = res
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def _args(integrator, precision, res=32, **overrides):
    """render_simulation's arguments on the card: the rk4 simulation
    golden input with its 2000-step budget (eight phases of
    PHASE_STEPS)."""
    cfg = _config(res, ray_integrator=RayIntegrator(integrator),
                  precision=precision, **overrides)
    render_fn, _, rays, _, _ = pipeline_simulation.make_simulation_renderer(
        cfg, device="cuda")
    return (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)


def _assert_identical(ours, ref):
    """Flags, n_samples, NaN sets and every other value bit for bit."""
    assert torch.equal(ours[1], ref[1]) and torch.equal(ours[2], ref[2])
    a, b = ours[0].cpu().numpy(), ref[0].cpu().numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)])
    assert np.nanmax(b) > 0.0


def _statistical_gate(a, b):
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels past
    1e-3 relative, total flux within 1e-3."""
    rel = np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.mean(np.nan_to_num(rel) > 1e-3) < 5e-3
    assert abs(np.nansum(a) - np.nansum(b)) < 1e-3 * abs(np.nansum(b))


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("integrator", ["rk4", "rk2"])
def test_phased_matches_monolithic(cuda_device, integrator, precision):
    """The phase kernel runs the monolithic kernel's loop cut at step
    boundaries, with the same rounding (neither unit contracts): the
    phased image is the monolithic one bit for bit."""
    args = _args(integrator, precision)
    before, phases_before = sk.LAUNCHES, sk.PHASE_LAUNCHES
    ref = sk.render_simulation(*args, integrator=integrator)
    stats = []
    ours = sk.render_simulation_phased(*args, integrator=integrator,
                                       phase_steps=PHASE_STEPS, stats=stats)
    assert sk.LAUNCHES == before + 1
    assert sk.PHASE_LAUNCHES == phases_before + len(stats)
    assert len(stats) > 2 and stats[-1]["survivors"] == 0
    assert any(s["survivors"] < s["rays"] for s in stats[:-1])
    _assert_identical(ours, ref)


def test_phased_many_frequencies(cuda_device):
    """18 frequencies: two launches per phase, the first leaving the ray
    state for the second."""
    args = _args("rk4", "float32", res=16, image_num_frequencies=18,
                 image_frequency_start=5e10, image_frequency_end=1e12,
                 image_frequency_spacing=FrequencySpacing.log)
    ref = sk.render_simulation(*args, integrator="rk4")
    stats = []
    phases_before = sk.PHASE_LAUNCHES
    ours = sk.render_simulation_phased(*args, integrator="rk4",
                                       phase_steps=PHASE_STEPS, stats=stats)
    assert sk.PHASE_LAUNCHES == phases_before + 2 * len(stats)
    assert ours[0].shape == (256, 18)
    _assert_identical(ours, ref)


@pytest.mark.parametrize("integrator, precision", [("rk4", "float64"),
                                                   ("rk2", "float32")])
def test_phase_kernel_matches_plain(cuda_device, integrator, precision):
    """One phase from the same carried state (the kernel's first phase)
    through the kernel and through its plain version: rk4 float64 keeps
    identical masks, n_samples and NaN sets and I_nu within rtol 1e-7
    (the card's transcendentals are not torch's, as for the monolithic
    kernel); rk2 float32 the statistical gate."""
    args = _args(integrator, precision)
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js \
        = args
    carry = sk.initial_carry(positions, directions, params, 1)
    index = torch.arange(positions.shape[0], dtype=torch.int32,
                         device=cuda_device)
    phase = (directions, mom, freqs, params, sp, grid, mass, cam, integrator)
    sk.render_simulation_phase(carry, index, 0, PHASE_STEPS, *phase)
    plain = sk.SimCarry(*(t.clone() for t in carry))
    before = sk.PHASE_LAUNCHES
    sk.render_simulation_phase(carry, index, PHASE_STEPS, PHASE_STEPS,
                               *phase)
    assert sk.PHASE_LAUNCHES == before + 1
    sk.render_simulation_phase_reference(plain, index, PHASE_STEPS,
                                         PHASE_STEPS, *phase)
    assert sk.PHASE_LAUNCHES == before + 1
    ours = sk.finish_rays(carry, index, freqs, log_js, True)
    ref = sk.finish_rays(plain, index, freqs, log_js, True)
    a, b = ours[0][:, 0].cpu().numpy(), ref[0][:, 0].cpu().numpy()
    assert np.nanmax(b) > 0.0
    if precision == "float64":
        # the plain version's lock step also marks rays that died earlier
        # in the phase truncated; only a live ray's trunc bit is carried on
        live = (carry.masks & sk.ALIVE) != 0
        for masks in (carry.masks, plain.masks):
            masks[~live] &= sk.ALIVE | sk.FLAG
        assert torch.equal(carry.masks, plain.masks)
        assert torch.equal(carry.n_samp, plain.n_samp)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=0.0)
    else:
        _statistical_gate(a, b)


def test_phase_rejects_bad_inputs(cuda_device):
    args = _args("rk4", "float64", res=4)
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js \
        = args
    carry = sk.initial_carry(positions, directions, params, 1)
    index = torch.arange(16, dtype=torch.int32, device=cuda_device)
    phase = (directions, mom, freqs, params, sp, grid, mass, cam)
    with pytest.raises(ValueError, match="rk4 and rk2 only"):
        sk.render_simulation_phase(carry, index, 0, 64, *phase,
                                   integrator="dp")
    with pytest.raises(TypeError):
        sk.render_simulation_phase(carry, index.cpu(), 0, 64, *phase)
    with pytest.raises(TypeError):
        sk.render_simulation_phase(carry, index.long(), 0, 64, *phase)
    before = sk.PHASE_LAUNCHES
    sk.render_simulation_phase(carry, index[:0], 0, 64, *phase)
    assert sk.PHASE_LAUNCHES == before


def test_pipeline_phased_run_on_cuda(cuda_device, tmp_path, monkeypatch):
    """pipeline.run with KERNEL_PHASED takes the phase kernel and gives
    the monolithic route's image bit for bit."""
    cfg = _config(res=16, output_file=str(tmp_path / "mono.npz"))
    before = sk.LAUNCHES
    ref = pipeline.run(cfg, quiet=True, device="cuda")
    assert sk.LAUNCHES == before + 1
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASED", True)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_STEPS",
                        PHASE_STEPS)
    monkeypatch.setattr(pipeline_simulation, "KERNEL_PHASE_CHUNK", 1)
    cfg.output_file = str(tmp_path / "phased.npz")
    phases_before = sk.PHASE_LAUNCHES
    ours = pipeline.run(cfg, quiet=True, device="cuda")
    assert sk.LAUNCHES == before + 1
    assert sk.PHASE_LAUNCHES > phases_before
    a, b = ours["I_nu"], ref["I_nu"]
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


# sampling modes of many blocks and the nearest cell on mock_amr.athdf
MESH_BLOCKS = {
    "interblock": {"simulation_file": str(FIXTURES / "mock_amr.athdf"),
                   "simulation_block_interp": True},
    "nearest": {"simulation_file": str(FIXTURES / "mock_amr.athdf"),
                "simulation_interp": False},
}


@pytest.mark.parametrize("integrator, precision", [("rk4", "float64"),
                                                   ("rk2", "float32")])
@pytest.mark.parametrize("mode", sorted(MESH_BLOCKS))
def test_phased_mesh_blocks_match_monolithic(cuda_device, mode, integrator,
                                             precision):
    """The phase kernel of many blocks: the phased image is the
    monolithic kernel's bit for bit (a phase starts its block search
    afresh, which changes where it starts, not what it finds)."""
    args = _args(integrator, precision, **MESH_BLOCKS[mode])
    ref = sk.render_simulation(*args, integrator=integrator)
    stats = []
    ours = sk.render_simulation_phased(*args, integrator=integrator,
                                       phase_steps=PHASE_STEPS, stats=stats)
    assert len(stats) > 2
    _assert_identical(ours, ref)


@pytest.mark.parametrize("mode", sorted(MESH_BLOCKS))
def test_phase_mesh_blocks_kernel_matches_plain(cuda_device, mode):
    """One phase of the phase kernel of many blocks from the kernel's
    carried state against its plain version, rk4 float64: identical
    n_samples and NaN sets, I_nu within rtol 1e-7."""
    args = _args("rk4", "float64", **MESH_BLOCKS[mode])
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js \
        = args
    carry = sk.initial_carry(positions, directions, params, 1)
    index = torch.arange(positions.shape[0], dtype=torch.int32,
                         device=cuda_device)
    phase = (directions, mom, freqs, params, sp, grid, mass, cam, "rk4")
    sk.render_simulation_phase(carry, index, 0, PHASE_STEPS, *phase)
    plain = sk.SimCarry(*(t.clone() for t in carry))
    before = sk.PHASE_LAUNCHES
    sk.render_simulation_phase(carry, index, PHASE_STEPS, PHASE_STEPS,
                               *phase)
    sk.render_simulation_phase_reference(plain, index, PHASE_STEPS,
                                         PHASE_STEPS, *phase)
    assert sk.PHASE_LAUNCHES == before + 1
    ours = sk.finish_rays(carry, index, freqs, log_js, True)
    ref = sk.finish_rays(plain, index, freqs, log_js, True)
    a, b = ours[0][:, 0].cpu().numpy(), ref[0][:, 0].cpu().numpy()
    assert np.nanmax(b) > 0.0
    assert torch.equal(carry.n_samp, plain.n_samp)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=1e-7, atol=0.0)
